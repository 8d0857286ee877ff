"""GoogLeNet Inception-v1 without auxiliary heads (counterpart of
``Inception_Layer_v1``, ``_v1_stem`` and ``Inception_v1_NoAuxClassifier``
in ``bigdl_tpu/models/inception/model.py``): the same modules, names and
parameter tree, so ``interop.load_jax_params`` moves the JAX model's
weights across as they are.

As in the JAX model, the stem's ReLU follows ``pool1`` (max commutes with
the ReLU, and the pass runs at 56x56 instead of 112x112) and is fused
into norm1; ``conv2/relu_3x3`` is fused into norm2 (``ReLUCrossMapLRN``:
one pass of the LRN kernel each). ``conv1`` computes no gradient to the
input. Weights are drawn from ``generator`` on the CPU and moved to
``device``.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import (Concat, Dropout, Linear, LogSoftMax, ReLU,
                                ReLUCrossMapLRN, Sequential,
                                SpatialAveragePooling, SpatialConvolution,
                                SpatialCrossMapLRN, SpatialMaxPooling, View)
from bigdl_tpu_torch.nn import init as init_mod

__all__ = ["Inception_Layer_v1", "Inception_v1_NoAuxClassifier"]


def _conv(*args, dev, **kw):
    return SpatialConvolution(*args, init_method=init_mod.Xavier, **dev,
                              **kw)


def Inception_Layer_v1(input_size, config, name_prefix="", *,
                       device="cuda",
                       generator: torch.Generator | None = None):
    """Branch-concat block: ``config`` = ((n1x1,), (n3x3r, n3x3),
    (n5x5r, n5x5), (npool,)), four branches concatenated on the
    channels."""
    dev = dict(device=device, generator=generator)
    concat = Concat(1).set_name(name_prefix + "output")
    concat.add(Sequential()
               .add(_conv(input_size, config[0][0], 1, 1, 1, 1, dev=dev)
                    .set_name(name_prefix + "1x1"))
               .add(ReLU().set_name(name_prefix + "relu_1x1")))
    concat.add(Sequential()
               .add(_conv(input_size, config[1][0], 1, 1, 1, 1, dev=dev)
                    .set_name(name_prefix + "3x3_reduce"))
               .add(ReLU().set_name(name_prefix + "relu_3x3_reduce"))
               .add(_conv(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1,
                          dev=dev).set_name(name_prefix + "3x3"))
               .add(ReLU().set_name(name_prefix + "relu_3x3")))
    concat.add(Sequential()
               .add(_conv(input_size, config[2][0], 1, 1, 1, 1, dev=dev)
                    .set_name(name_prefix + "5x5_reduce"))
               .add(ReLU().set_name(name_prefix + "relu_5x5_reduce"))
               .add(_conv(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2,
                          dev=dev).set_name(name_prefix + "5x5"))
               .add(ReLU().set_name(name_prefix + "relu_5x5")))
    concat.add(Sequential()
               .add(SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()
                    .set_name(name_prefix + "pool"))
               .add(_conv(input_size, config[3][0], 1, 1, 1, 1, dev=dev)
                    .set_name(name_prefix + "pool_proj"))
               .add(ReLU().set_name(name_prefix + "relu_pool_proj")))
    return concat


def _v1_stem(*, device="cuda", generator=None):
    """conv1 .. pool2, the stem the Inception-v1 variants share."""
    dev = dict(device=device, generator=generator)
    return (Sequential()
            .add(_conv(3, 64, 7, 7, 2, 2, 3, 3, 1, propagate_back=False,
                       dev=dev).set_name("conv1/7x7_s2"))
            .add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                 .set_name("pool1/3x3_s2"))
            .add(ReLUCrossMapLRN(
                ReLU().set_name("conv1/relu_7x7"),
                SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("pool1/norm1")))
            .add(_conv(64, 64, 1, 1, 1, 1, dev=dev)
                 .set_name("conv2/3x3_reduce"))
            .add(ReLU().set_name("conv2/relu_3x3_reduce"))
            .add(_conv(64, 192, 3, 3, 1, 1, 1, 1, dev=dev)
                 .set_name("conv2/3x3"))
            .add(ReLUCrossMapLRN(
                ReLU().set_name("conv2/relu_3x3"),
                SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("conv2/norm2")))
            .add(SpatialMaxPooling(3, 3, 2, 2).ceil()
                 .set_name("pool2/3x3_s2")))


def Inception_v1_NoAuxClassifier(class_num: int, *, device="cuda",
                                 generator: torch.Generator | None = None
                                 ) -> Sequential:
    """Inception-v1 with the main head only: log-probabilities over
    ``class_num`` classes from (N, 3, 224, 224) images."""
    dev = dict(device=device, generator=generator)
    model = _v1_stem(**dev)
    model.add(Inception_Layer_v1(
        192, ((64,), (96, 128), (16, 32), (32,)), "inception_3a/", **dev))
    model.add(Inception_Layer_v1(
        256, ((128,), (128, 192), (32, 96), (64,)), "inception_3b/", **dev))
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool3/3x3_s2"))
    model.add(Inception_Layer_v1(
        480, ((192,), (96, 208), (16, 48), (64,)), "inception_4a/", **dev))
    model.add(Inception_Layer_v1(
        512, ((160,), (112, 224), (24, 64), (64,)), "inception_4b/", **dev))
    model.add(Inception_Layer_v1(
        512, ((128,), (128, 256), (24, 64), (64,)), "inception_4c/", **dev))
    model.add(Inception_Layer_v1(
        512, ((112,), (144, 288), (32, 64), (64,)), "inception_4d/", **dev))
    model.add(Inception_Layer_v1(
        528, ((256,), (160, 320), (32, 128), (128,)), "inception_4e/",
        **dev))
    model.add(SpatialMaxPooling(3, 3, 2, 2).ceil().set_name("pool4/3x3_s2"))
    model.add(Inception_Layer_v1(
        832, ((256,), (160, 320), (32, 128), (128,)), "inception_5a/",
        **dev))
    model.add(Inception_Layer_v1(
        832, ((384,), (192, 384), (48, 128), (128,)), "inception_5b/",
        **dev))
    model.add(SpatialAveragePooling(7, 7, 1, 1).set_name("pool5/7x7_s1"))
    model.add(Dropout(0.4).set_name("pool5/drop_7x7_s1"))
    model.add(View(1024))
    model.add(Linear(1024, class_num, init_method=init_mod.Xavier, **dev)
              .set_name("loss3/classifier"))
    model.add(LogSoftMax().set_name("loss3/loss3"))
    return model

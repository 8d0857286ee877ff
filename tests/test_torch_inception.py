"""The port's Inception-v1 path (bigdl_tpu_torch.nn conv, pooling,
Concat, View, ClassNLL, Dropout; models.inception; the harness's
``-m inception_v1``) against the JAX package on the same numpy inputs
and weights: a JAX params tree drawn with numpy (``_numpy_params``; the
JAX package's own init compiles layer by layer, or for some 13 s as one
jit, on one CPU) and moved into the port by ``load_jax_params``, which
takes Inception-v1's nested Concat tree as it stands.

Tolerances, stated with their reasons:

- modules in f32: 1e-5 relative and absolute (convolutions and window
  sums in another order and by other routines).
- the stem and ``inception_3a`` under the bf16 policy (f32 params, bf16
  compute and activations): both sides round each conv to bf16 and add
  the bf16 bias (a second rounding), so activations agree but for one
  bf16 step in a few elements per thousand; such a step can flip which
  element of a pooling window is the maximum, and the JAX CPU path's
  LRN backward rounds its saved factors to bf16 where the port
  recomputes them in f32 (the Pallas kernel's arithmetic). Outputs and
  gradients are held to 2^-4 of their largest element (4.2 % seen).
- one whole harness step of ``Inception_v1_NoAuxClassifier(10)`` at
  batch 2, 224x224, f32, dropout at p = 0: the loss within 1e-5 (sums
  of 60 f32 convolutions in another order); the gradients, and each
  parameter's update after one SGD(0.01, momentum 0.9) step, within
  1e-2 of their largest element, each parameter within 1e-6 of its
  largest element beyond that. Two activations within f32 rounding of
  each other can swap order in a max-pool window, which routes that
  window's cotangent to the neighbouring pixel and moves every
  gradient below it: with the JAX package's own initialisation one
  such swap in ``inception_5b``'s pool moved the lower layers'
  gradients by up to 0.6 % of their largest element; with these
  weights they agree within 0.15 %.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import Inception_Layer_v1 as JLayer
from bigdl_tpu.models import Inception_v1_NoAuxClassifier as JInception
from bigdl_tpu.models.inception.model import _v1_stem as j_stem
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.tensor import DTypePolicy as JPolicy
from bigdl_tpu.tensor import policy_scope as jscope
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.interop import load_jax_params, params_from_jax
from bigdl_tpu_torch.models import (Inception_Layer_v1,
                                    Inception_v1_NoAuxClassifier)
from bigdl_tpu_torch.models.inception.model import _v1_stem
from bigdl_tpu_torch.models.utils import perf
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.tensor import DTypePolicy, policy_scope


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(jm, tm, seed=0):
    """Weights for the JAX module (``_numpy_params``), copied into the
    port's; the JAX module's params and state."""
    params = _numpy_params(jm, seed)
    load_jax_params(tm, params)
    return params, jm.init_state()


def _jax_fwd_grads(jm, params, state, x, ct, training=True):
    """JAX output and the gradients of <output, ct> wrt the input and the
    params (one jit, traced under the caller's policy)."""
    def f(p, v, c):
        y, vjp = jax.vjp(lambda pp, vv: jm.apply(
            pp, state, vv, training=training)[0], p, v)
        gp, gx = vjp(c.astype(y.dtype))
        return y, gx, gp
    return jax.jit(f)(params, x, ct)


def _torch_fwd_grads(tm, x, ct):
    xg = x.clone().requires_grad_()
    y = tm(xg)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(y, [xg, *named.values()],
                                ct.to(y.dtype), allow_unused=True)
    return y, grads[0], dict(zip(named, grads[1:]))


def _close(got, want, tol, what, scale=None):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if scale is not None:       # relative to the largest element
        tol = tol * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _check_module(jm, tm, shape, seed, what):
    params, state = _pair(jm, tm, seed)
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    out = jax.eval_shape(lambda v: jm.apply(params, state, v)[0],
                         jnp.asarray(x))
    ct = rs.standard_normal(out.shape).astype(np.float32)
    jy, jgx, jgp = _jax_fwd_grads(jm, params, state, jnp.asarray(x),
                                  jnp.asarray(ct), training=False)
    ty, tgx, tgp = _torch_fwd_grads(tm, torch.as_tensor(x),
                                    torch.as_tensor(ct))
    _close(ty, jy, 1e-5, f"{what} output")
    _close(tgx, jgx, 1e-5, f"{what} dx")
    want = params_from_jax(_host(jgp))
    assert set(want) == set(tgp)
    for name, g in tgp.items():
        _close(g, want[name], 1e-5, f"{what} grad {name}")


@pytest.mark.parametrize("args,kw,shape", [
    ((3, 8, 3, 5, 2, 1, 1, 2), {}, (2, 3, 11, 9)),
    ((4, 6, 3, 3, 1, 1, 1, 1, 2), {"init_method": "xavier"}, (2, 4, 7, 7)),
    ((3, 4, 1, 1), {"with_bias": False}, (3, 6, 6)),
])
def test_spatial_convolution(args, kw, shape):
    _check_module(jnn.SpatialConvolution(*args, **kw),
                  tnn.SpatialConvolution(*args, **kw, device="cpu"),
                  shape, 1, "conv")


def test_conv_propagate_back_false_cuts_dx():
    tm = tnn.SpatialConvolution(3, 4, 3, 3, propagate_back=False,
                                device="cpu")
    x = torch.randn((1, 3, 5, 5), requires_grad=True)
    y = tm(x)
    (gx,) = torch.autograd.grad(y.sum(), x, allow_unused=True)
    assert gx is None and y.requires_grad


@pytest.mark.parametrize("make,shape", [
    # the stem's 3x3 s2 ceil: 10 -> 5 with a one-row/col overhang
    (lambda m: m.SpatialMaxPooling(3, 3, 2, 2).ceil(), (2, 3, 10, 10)),
    # the in-block 3x3 s1 pad 1 ceil
    (lambda m: m.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(), (2, 3, 7, 6)),
    (lambda m: m.SpatialMaxPooling(2, 2), (1, 2, 5, 5)),
    # the aux heads' 5x5 s3 ceil average on 14x14 (no overhang) and on
    # 15x15 (two rows/cols of overhang, divided by 25 as in JAX)
    (lambda m: m.SpatialAveragePooling(5, 5, 3, 3).ceil(), (2, 3, 14, 14)),
    (lambda m: m.SpatialAveragePooling(5, 5, 3, 3).ceil(), (2, 3, 15, 15)),
    (lambda m: m.SpatialAveragePooling(3, 3, 2, 2, 1, 1).ceil(),
     (2, 3, 8, 8)),
    (lambda m: m.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                       count_include_pad=False).ceil(),
     (2, 3, 8, 8)),
    (lambda m: m.SpatialAveragePooling(3, 3, 2, 2, divide=False),
     (2, 3, 9, 9)),
    (lambda m: m.SpatialAveragePooling(7, 7, 1, 1), (2, 4, 7, 7)),
])
def test_pooling(make, shape):
    _check_module(make(jnn), make(tnn), shape, 2, "pool")


def test_concat_and_view():
    def build(m, **dev):
        return (m.Sequential()
                .add(m.Concat(1)
                     .add(m.SpatialConvolution(3, 4, 1, 1, **dev))
                     .add(m.Sequential()
                          .add(m.SpatialConvolution(3, 2, 3, 3, 1, 1, 1, 1,
                                                    **dev))
                          .add(m.ReLU())))
                .add(m.View(6 * 4 * 4)))
    _check_module(build(jnn), build(tnn, device="cpu"), (2, 3, 4, 4), 3,
                  "concat+view")
    v = tnn.View(2, 3)
    assert v(torch.zeros(6)).shape == (2, 3)
    assert v(torch.zeros(4, 6)).shape == (4, 2, 3)
    assert tnn.View(-1)(torch.zeros(4, 6)).shape == (24,)
    assert tnn.View(6).set_num_input_dims(1)(torch.zeros(4, 6)).shape == (
        4, 6)


@pytest.mark.parametrize("weights,size_average", [(None, True),
                                                  ([1.0, 2.0, 0.5], True),
                                                  ([1.0, 2.0, 0.5], False)])
def test_class_nll(weights, size_average):
    rs = np.random.default_rng(4)
    logp = np.log(rs.dirichlet(np.ones(3), size=5)).astype(np.float32)
    t = rs.integers(1, 4, size=5)
    jc = jnn.ClassNLLCriterion(weights, size_average)
    jl, jg = jax.value_and_grad(lambda v: jc.apply(v, jnp.asarray(t)))(
        jnp.asarray(logp))
    x = torch.as_tensor(logp).requires_grad_()
    tl = tnn.ClassNLLCriterion(weights, size_average)(x, torch.as_tensor(t))
    (tg,) = torch.autograd.grad(tl, x)
    _close(tl, jl, 1e-6, "loss")
    _close(tg, jg, 1e-6, "grad")


class TestDropout:
    def test_mask_statistics_and_scale(self):
        d = tnn.Dropout(0.3, generator=torch.Generator().manual_seed(0))
        d.train()
        y = d(torch.ones((400, 500)))
        dropped = float((y == 0).float().mean())
        # 200k Bernoulli(0.3) draws: 5 standard deviations is 0.005
        assert abs(dropped - 0.3) < 0.005
        assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
        d.scale = False
        assert set(d(torch.ones(1000)).unique().tolist()) == {0.0, 1.0}

    def test_seeded_generator_is_deterministic_and_advances(self):
        def run(seed):
            d = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(
                seed))
            d.train()
            x = torch.ones(256, dtype=torch.bfloat16)
            return d(x), d(x)
        (a1, a2), (b1, _), (c1, _) = run(7), run(7), run(8)
        assert a1.dtype == torch.bfloat16
        assert torch.equal(a1, b1) and not torch.equal(a1, a2)
        assert not torch.equal(a1, c1)

    def test_identity_in_evaluate_and_at_p0(self):
        x = torch.randn(10, 10)
        d = tnn.Dropout(0.4)
        d.evaluate()
        assert d(x) is x
        d.train()
        with pytest.raises(ValueError, match="generator"):
            d(x)
        assert d.set_p(0.0)(x) is x


def _numpy_params(jm, seed):
    """A params tree of the JAX module's structure, every leaf uniform in
    ±sqrt(6 / (fan_in + fan_out)) from numpy (the JAX package's init
    compiles layer by layer, or for some 13 s as one jit, on one CPU)."""
    rs = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        shape = tree.shape
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        lim = np.sqrt(6.0 / (fan_in + shape[0]))
        return rs.uniform(-lim, lim, shape).astype(np.float32)
    return fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def _set_p0(model):
    for m in model.modules():
        if isinstance(m, tnn.Dropout):
            m.set_p(0.0)


_BF16 = dict(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
             activation_dtype=torch.bfloat16)
_JBF16 = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.bfloat16,
                 activation_dtype=jnp.bfloat16)


def test_stem_and_block_under_the_bf16_policy():
    """conv1 .. pool2 and ``inception_3a`` on 64x64 images: both LRN
    layers (norm1 at 16x16, norm2 at 16x16), the ceil pools and a Concat,
    in bf16 activations."""
    def build(stem, layer, **dev):
        m = stem(**dev)
        m.add(layer(192, ((64,), (96, 128), (16, 32), (32,)),
                    "inception_3a/", **dev))
        return m
    jm = build(j_stem, JLayer)
    tm = build(_v1_stem, Inception_Layer_v1, device="cpu")
    params, state = _pair(jm, tm, 5)
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 3, 64, 64)).astype(np.float32)
    ct = rs.standard_normal((2, 256, 8, 8)).astype(np.float32)
    with jscope(_JBF16):
        jy, _, jgp = _jax_fwd_grads(jm, params, state, jnp.asarray(x),
                                    jnp.asarray(ct))
    with policy_scope(DTypePolicy(**_BF16)):
        ty, _, tgp = _torch_fwd_grads(tm, torch.as_tensor(x),
                                      torch.as_tensor(ct))
    assert ty.dtype == torch.bfloat16 and ty.shape == (2, 256, 8, 8)
    _close(ty, jy, 2 ** -4, "output", scale=True)
    want = params_from_jax(_host(jgp))
    assert set(want) == set(tgp)
    for name, g in tgp.items():
        if name.startswith("0."):   # conv1: no dx, its own grads only
            assert g is not None
        _close(g, want[name], 2 ** -4, f"grad {name}", scale=True)


def test_whole_harness_step_matches_jax():
    """One ``perf.py -m inception_v1`` step at f32 (the JAX harness's
    ``step``: ClassNLL on the model's log-probabilities, SGD(0.01,
    momentum 0.9)) on batch 2 at 224x224, 10 classes, dropout at p = 0."""
    jm = JInception(10)
    for m in jm.modules:
        if isinstance(m, jnn.Dropout):
            m.set_p(0.0)
    params = _numpy_params(jm, 0)
    state = jm.init_state()
    host = np.random.default_rng(0)
    data = host.standard_normal((2, 3, 224, 224), np.float32)
    labels = host.integers(1, 11, size=(2,))
    crit = jnn.ClassNLLCriterion()
    joptim = JSGD(learning_rate=0.01, momentum=0.9)

    def loss_fn(p):
        y, _ = jm.apply(p, state, jnp.asarray(data), training=True)
        return crit.apply(y, jnp.asarray(labels))
    jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jp2, _ = jax.jit(lambda g, p: joptim.update(g, p, joptim.init_state(p)))(
        jg, params)

    tm = Inception_v1_NoAuxClassifier(10, device="cpu")
    load_jax_params(tm, _host(params))
    tm.train()
    _set_p0(tm)
    td, tl = torch.as_tensor(data), torch.as_tensor(labels)
    named = dict(tm.named_parameters())
    loss = tnn.ClassNLLCriterion()(tm(td), tl)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    _close(loss, jloss, 1e-5, "loss")
    want = params_from_jax(_host(jg))
    assert set(want) == set(grads)
    for name, g in grads.items():
        _close(g, want[name], 1e-2, f"grad {name}", scale=True)

    before = {n: p.detach().clone() for n, p in named.items()}
    sgd = SGD(learning_rate=0.01, momentum=0.9)
    step = perf.make_conv_step(tm, sgd)
    state, sloss = step(sgd.init_state(named), td, tl, 1)
    _close(sloss, jloss, 1e-5, "step loss")
    assert state["neval"] == 1
    want = params_from_jax(_host(jp2))
    for name, p in tm.named_parameters():
        # the parameter within f32 steps, its update as the gradient
        w = want[name].numpy()
        delta = w - before[name].numpy()
        limit = 1e-6 * np.abs(w).max() + 1e-2 * np.abs(delta).max()
        assert np.abs(p.detach().numpy() - w).max() <= limit, name

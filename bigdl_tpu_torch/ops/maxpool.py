"""3x3 / stride-1 / SAME max pool with a hand-written backward
(counterpart of ``bigdl_tpu/ops/pallas/maxpool.py``).

``maxpool3x3s1(x)`` is an opt-in function, as in the JAX package:
``nn.SpatialMaxPooling`` does not dispatch to it. Its forward is the
library max pool (the JAX package computes it outside Pallas with
``reduce_window``); its backward, from the forward's y as the residual,
is

    dx[p] = Σ over the windows o covering p of dy[o] · [p is o's first
            position, in row-major order, where x == y[o]]

— the first-max tie rule of Torch and of XLA's select-and-scatter. On a
CUDA tensor ``maxpool3x3s1_bwd`` launches the hand-written Hopper kernel
of ``csrc/maxpool.cu`` (built at first use, see ``_build.py``) or
raises; on a CPU tensor it takes ``maxpool3x3s1_bwd_ref``, the plain
version: the TPU kernel's nine shifted compares with a running "taken"
mask (``maxpool.py:120-132``). Both accumulate dx in f32 in the same
order and round once, so they agree bit for bit; the JAX kernel sums in
dy's dtype, which agrees with them wherever the sums are exact (integer
cotangents).

Out-of-image x takes ``FILL``, float32's lowest finite value, as in the
JAX kernel (``maxpool.py:90``), and not -inf: a window whose in-image
maximum is -inf would otherwise match first at a padded position and
drop its cotangent, where the JAX kernel and the library send it to the
window's first in-image position. bf16 compares in f32 after an exact
cast, so no bf16 value equals ``FILL``; NaN matches nothing, so a window
whose maximum is NaN sends its cotangent nowhere, as in the JAX kernel.

``bwd_launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["FILL", "maxpool3x3s1", "maxpool3x3s1_bwd",
           "maxpool3x3s1_bwd_ref", "bwd_launches"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since import (reset by assigning 0)
bwd_launches = 0


#: out-of-image x: float32's lowest finite value, as in the JAX kernel
#: (``maxpool.py:90``)
FILL = torch.finfo(torch.float32).min


def maxpool3x3s1_bwd_ref(x, y, dy):
    """Plain version of :func:`maxpool3x3s1_bwd`: dx in x's dtype."""
    h, w = x.shape[2], x.shape[3]
    # x padded by 2 (FILL): window grid rows/cols [-1, H], positions
    # [-2, H+1]; y and dy padded by 1 (FILL / 0); compares in f32 after
    # an exact cast of bf16
    xp = F.pad(x.float(), (2, 2, 2, 2), value=FILL)
    yp = F.pad(y.float(), (1, 1, 1, 1), value=FILL)
    gp = F.pad(dy.float(), (1, 1, 1, 1))
    taken = torch.zeros(yp.shape, dtype=torch.bool, device=x.device)
    acc = torch.zeros(x.shape[:2] + (h + 4, w + 4), dtype=torch.float32,
                      device=x.device)
    for dr in (-1, 0, 1):          # row-major window order: first max
        for dc in (-1, 0, 1):
            v = xp[:, :, 1 + dr:1 + dr + h + 2, 1 + dc:1 + dc + w + 2]
            take = (v == yp) & ~taken
            taken = taken | take
            contrib = torch.where(take, gp, torch.zeros_like(gp))
            acc = acc + F.pad(contrib, (1 + dc, 1 - dc, 1 + dr, 1 - dr))
    return acc[:, :, 2:2 + h, 2:2 + w].to(x.dtype)


@functools.cache
def _kernel_fn():
    """The typed C entry of csrc/maxpool.cu, built at first use."""
    from bigdl_tpu_torch.ops._build import load_library
    fn = load_library("maxpool.cu").bigdl_maxpool3x3s1_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _check(cond, msg):
    if not cond:
        raise ValueError(f"maxpool3x3s1: {msg}")


def maxpool3x3s1_bwd(x, y, dy):
    """dx (x's dtype) of the 3x3 / stride-1 / SAME max pool from the
    input x, the forward's output y and the cotangent dy, all (N, C, H, W)
    of one dtype."""
    if x.device.type == "cpu":
        return maxpool3x3s1_bwd_ref(x, y, dy)
    global bwd_launches
    _check(x.is_cuda and y.device == x.device and dy.device == x.device,
           "x, y and dy must be on one CUDA device")
    _check(x.dim() == 4, f"need an NCHW tensor, got shape {tuple(x.shape)}")
    _check(x.dtype in _DTYPE_CODES,
           f"dtype {x.dtype} not supported (float32 or bfloat16)")
    for t in (x, y, dy):
        _check(t.shape == x.shape and t.dtype == x.dtype,
               "x, y and dy must match in shape and dtype")
        _check(t.is_contiguous(), "inputs must be contiguous NCHW")
    dx = torch.empty_like(x)
    if not x.numel():
        return dx
    n, c, h, w = x.shape
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), n, c, h, w, stream)
    if err:
        raise RuntimeError(f"maxpool3x3s1_bwd kernel launch failed "
                           f"(code {err})")
    bwd_launches += 1
    return dx


def _fwd(x):
    return F.max_pool2d(x, 3, 1, 1)


class _MaxPool3x3s1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # autograd may hand over a broadcast or strided cotangent
        return maxpool3x3s1_bwd(x, y, g.contiguous())


def maxpool3x3s1(x):
    """3x3 / stride-1 / SAME max pool over NCHW ``x``: the library
    forward, the hand-written backward (first-max ties, bit-exact)."""
    return _MaxPool3x3s1.apply(x)

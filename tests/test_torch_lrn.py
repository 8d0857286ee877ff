"""The port's cross-map LRN (bigdl_tpu_torch.ops.lrn and the nn modules
over it) against the JAX package: the Pallas kernel
(``bigdl_tpu/ops/pallas/lrn.py``) in interpret mode and the XLA path
``_lrn`` (``bigdl_tpu/nn/normalization.py``), on the same numpy inputs,
for odd and even window sizes, with and without the fused ReLU, in f32
and bf16.

On CPU tensors the port's wrappers take their plain versions
(``lrn_ref`` / ``lrn_bwd_ref``), which recompute s, s^-β and s^-β/s in
f32 as the Pallas kernel does. Tolerances, element by element as
|port − jax| <= rtol·|jax| + atol·rms(jax):

- f32, against either JAX path: rtol = atol = 1e-5 (the window sums
  and the square roots are taken in another order and by other
  routines; a few f32 steps).
- bf16 against the Pallas kernel: the same f32 arithmetic on the same
  bf16 inputs, rounded once to bf16, so an element may land one bf16
  step away (rtol 2^-7) where the f32 values straddle a rounding
  boundary; atol 1e-4 covers dx elements that are a small difference
  of two large terms.
- bf16 against ``_lrn``: that path rounds its saved s^-β and s^-β/s to
  bf16 (2^-9 relative each) before the backward, so its dx is held at
  rtol = atol = 2^-5; its forward rounds like the kernel's (2^-7, 1e-4).

The plain versions are also held against a float64 statement of the
definition and its autograd gradient (the independent oracle of
``tests/test_perf_paths.py``): they compute in f32, so rtol = atol = 1e-6 (a
few f32 steps; atol for the dx elements that cancel).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.normalization import _lrn
from bigdl_tpu.ops.pallas import lrn as plrn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops import lrn as tlrn
from bigdl_tpu_torch.ops import pow_neg_beta

_SHAPE = (2, 13, 5, 7)        # odd C, H·W 35: no tile or vector divides


def _inputs(seed, dtype):
    rs = np.random.default_rng(seed)
    x = (1.5 * rs.standard_normal(_SHAPE)).astype(np.float32)
    ct = rs.standard_normal(_SHAPE).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (jnp.asarray(x, jd), jnp.asarray(ct, jd),
            torch.as_tensor(x).to(td), torch.as_tensor(ct).to(td))


def _hold(got, want, rtol, atol, what):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    limit = rtol * np.abs(want) + atol * np.sqrt(np.mean(want ** 2))
    worst = np.max(np.abs(got - want) - limit)
    assert worst <= 0, f"{what}: past the limit by {worst}"


def _jax_fwd_grad(fn, x, ct):
    y, vjp = jax.vjp(fn, x)
    return y, vjp(ct)[0]


_ARGS = dict(alpha=0.5, beta=0.75, k=1.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("size", [4, 5, 11, 16])
def test_lrn_matches_pallas_kernel(size, relu, dtype):
    jx, jct, tx, tct = _inputs(size + 2 * relu, dtype)
    a = _ARGS
    jy, jdx = _jax_fwd_grad(lambda v: plrn.lrn(
        v, size, a["alpha"], a["beta"], a["k"], True, relu), jx, jct)
    xg = tx.clone().requires_grad_()
    y = tlrn.lrn(xg, size, relu=relu, **a)
    (dx,) = torch.autograd.grad(y, xg, tct)
    tol = (1e-5, 1e-5) if dtype == "f32" else (2 ** -7, 1e-4)
    assert y.dtype == tx.dtype and dx.dtype == tx.dtype
    _hold(y, jy, *tol, "forward")
    _hold(dx, jdx, *tol, "dx")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("size", [4, 5])
def test_lrn_matches_xla_path(size, dtype):
    """``_lrn`` has no fused ReLU: the JAX module runs ReLU, then it."""
    jx, jct, tx, tct = _inputs(10 + size, dtype)
    a = _ARGS
    jy, jdx = _jax_fwd_grad(lambda v: _lrn(
        jax.nn.relu(v), size, a["alpha"], a["beta"], a["k"]), jx, jct)
    y = tlrn.lrn_ref(tx, size, relu=True, **a)
    dx = tlrn.lrn_bwd_ref(tct, tx, size, relu=True, **a)
    if dtype == "f32":
        _hold(y, jy, 1e-5, 1e-5, "forward")
        _hold(dx, jdx, 1e-5, 1e-5, "dx")
    else:
        _hold(y, jy, 2 ** -7, 1e-4, "forward")
        _hold(dx, jdx, 2 ** -5, 2 ** -5, "dx")


def _lrn_direct(x, size, alpha, beta, k):
    """Plain statement of the definition, differentiated by autograd."""
    half = (size - 1) // 2
    p = torch.nn.functional.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    s = k + (alpha / size) * sum(p[:, d:d + x.shape[1]] for d in range(size))
    return x * s ** (-beta)


@pytest.mark.parametrize("size,beta", [(1, 0.75), (4, 0.75), (5, 0.5),
                                       (6, 1.0), (9, 0.6), (11, 0.75),
                                       (16, 0.5)])
def test_analytic_backward_matches_autodiff(size, beta):
    x = torch.as_tensor(np.random.default_rng(size).standard_normal(
        _SHAPE)).double()
    ct = torch.as_tensor(np.random.default_rng(size + 1).standard_normal(
        _SHAPE)).double()
    xg = x.clone().requires_grad_()
    want = torch.autograd.grad(_lrn_direct(xg, size, 0.5, beta, 2.0), xg,
                               ct)[0]
    got = tlrn.lrn_bwd_ref(ct, x, size, 0.5, beta, 2.0)
    _hold(got, want.numpy(), 1e-6, 1e-6, "dx")
    _hold(tlrn.lrn_ref(x, size, 0.5, beta, 2.0),
          _lrn_direct(x, size, 0.5, beta, 2.0).numpy(), 1e-6, 1e-6, "y")


def test_relu_mask_is_on_the_pre_relu_input():
    """With relu, dx is zero where x <= 0 and equals the LRN backward of
    max(x, 0) elsewhere."""
    _, _, x, ct = _inputs(3, "f32")
    got = tlrn.lrn_bwd_ref(ct, x, 5, relu=True, **_ARGS)
    plain = tlrn.lrn_bwd_ref(ct, torch.clamp_min(x, 0), 5, **_ARGS)
    assert torch.all(got[x <= 0] == 0)
    torch.testing.assert_close(got[x > 0], plain[x > 0])


def test_pow_neg_beta_special_cases():
    s = torch.linspace(0.5, 40.0, 101)
    for beta in (0.75, 0.5, 1.0, 0.6):
        torch.testing.assert_close(pow_neg_beta(s, beta), s ** -beta,
                                   rtol=2e-6, atol=0)


def test_modules_take_the_plain_path_on_cpu_tensors():
    """``ReLUCrossMapLRN`` equals its two children run in order, forward
    and backward, and a CPU run launches no kernel."""
    _, _, x, ct = _inputs(4, "f32")
    before = (tlrn.fwd_launches, tlrn.bwd_launches)
    fused = tnn.ReLUCrossMapLRN(tnn.ReLU(), tnn.SpatialCrossMapLRN(
        5, 1e-2, 0.75))
    seq = tnn.Sequential(tnn.ReLU(), tnn.SpatialCrossMapLRN(5, 1e-2, 0.75))
    assert list(fused._modules) == ["0", "1"] and fused.params == {
        "0": {}, "1": {}}
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = fused(xa), seq(xb)
    torch.testing.assert_close(ya, yb)
    (ga,), (gb,) = (torch.autograd.grad(y, v, ct)
                    for y, v in ((ya, xa), (yb, xb)))
    torch.testing.assert_close(ga, gb)
    assert (tlrn.fwd_launches, tlrn.bwd_launches) == before


def test_wrapper_refuses_non_cuda_non_cpu_tensors():
    """Off the CPU a wrapper launches its kernel or raises: a meta tensor
    is refused, not handed to the plain version."""
    x = torch.empty(_SHAPE, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tlrn.lrn_fwd(x)
    with pytest.raises(ValueError, match="CUDA"):
        tlrn.lrn_bwd(x, x)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("size", [2, 4, 11, 16, 17])
def test_window_is_the_jax_band(size, adjoint):
    """The window (and its mirror, the adjoint) the plain versions and
    the kernels sum, [c - lo, c + hi] with lo = (size - 1) // 2 and hi =
    size - 1 - lo, is the JAX kernel's ``_band_matrix``, asymmetric for
    even sizes (which the card's kernels past 9 take too):
    exact on integer-valued f32 inputs, C 13 narrower than size 16 and
    17."""
    rs = np.random.default_rng(size)
    v = rs.integers(-8, 9, size=(2, 13, 3, 1)).astype(np.float32)
    band = plrn._band_matrix(13, size, adjoint)
    want = np.einsum("dc,nchw->ndhw", band, v)
    got = tlrn._window_sum(torch.from_numpy(v), size, adjoint=adjoint)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_takes_every_window_size_off_the_cpu():
    """Windows past 9 (the register ring's instantiations) are no longer
    refused: off the CPU the wrappers stop only at the device check (a
    meta tensor stands in for the card's)."""
    x = torch.empty(_SHAPE, device="meta")
    for size in (10, 11, 16, 64):
        with pytest.raises(ValueError, match="one CUDA device"):
            tlrn.lrn_fwd(x, size)
        with pytest.raises(ValueError, match="one CUDA device"):
            tlrn.lrn_bwd(x, x, size)


# --------------------------------------------------------------------------
# the staged backward (csrc/lrn.cu, lrn_bwd_staged_kernel) on the CPU
# --------------------------------------------------------------------------

def _pow_pair(s, beta):
    """s^-β and s^-β / s as the staged kernel's ``pow_pair`` forms them:
    q = rsqrt(s), 1/s = q²; β 0.75: q²·rsqrt(q); 0.5: q; 1: 1/s (the
    SFU's approximations stand as torch's)."""
    if beta == 0.75:
        q = torch.rsqrt(s)
        q2 = q * q
        b = q2 * torch.rsqrt(q)
        return b, b * q2
    if beta == 0.5:
        q = torch.rsqrt(s)
        return q, q * q * q
    if beta == 1.0:
        b = torch.reciprocal(s)
        return b, b * b
    b = torch.pow(s, -beta)
    return b, b * torch.reciprocal(s)


def _staged_walk(g, x, size, alpha, beta, k, relu, run=None):
    """The staged backward's walk in its order, in f32: runs of P
    positions of each plane (``run_positions``, or ``run``), chunks of
    ``chunk_channels(size)`` channels, one step a channel i that reads r_i,
    completes the window of j = i - hi (s, u = g·s^-β, t = g·r·s^-β/s)
    and writes dx of c = i - size + 1; rings of r, u and t indexed by
    channel mod their length: ``size`` slots up to 9 (the registers:
    out-of-range channels hold zeros, every window sum runs over all
    slots), past it min(size, C) of r and t and ``u_slots`` of u (the
    shared-memory slots: sums over the in-range channels only). dx
    rounds once to x's dtype."""
    n, c, h, w = x.shape
    hw = h * w
    xf = x.float().reshape(n, c, hw)
    gf = g.float().reshape(n, c, hw)
    dx = torch.empty_like(xf)
    p = run or tlrn.run_positions(hw, x.dtype, size, c)
    cc = tlrn.chunk_channels(size)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    coef, coef2 = alpha / size, 2.0 * alpha * beta / size
    regs = size <= 9
    slots = size if regs else min(size, c)
    uslots = slots if regs else tlrn.u_slots(size, slots)

    def window(first, last):
        """Channels a sum visits, in order: every slot's in registers,
        the in-range ones in shared memory."""
        return (range(first, last + 1) if regs
                else range(max(first, 0), min(last, c - 1) + 1))

    for p0 in range(0, hw, p):
        cols = slice(p0, min(p0 + p, hw))
        zero = torch.zeros(n, cols.stop - p0)
        ring_r, ring_t = [zero] * slots, [zero] * slots
        ring_u = [zero] * uslots
        for kc in range(-(-(c + size - 1) // cc)):
            for q in range(cc):
                i = kc * cc + q
                j, co = i - hi, i - size + 1
                if i < c:
                    r = xf[:, i, cols]
                    ring_r[i % slots] = (torch.where(r < 0, 0.0, r)
                                         if relu else r)
                elif regs:
                    ring_r[i % slots] = zero
                if 0 <= j < c:
                    acc = zero
                    for ch in window(j - lo, j + hi):
                        acc = acc + ring_r[ch % slots] * ring_r[ch % slots]
                    b, bs = _pow_pair(k + coef * acc, beta)
                    gj = gf[:, j, cols]
                    ring_u[j % uslots] = gj * b
                    ring_t[j % slots] = gj * ring_r[j % slots] * bs
                elif regs:
                    ring_u[j % uslots] = ring_t[j % slots] = zero
                if 0 <= co < c:
                    acc = zero
                    for ch in window(co - hi, co + lo):
                        acc = acc + ring_t[ch % slots]
                    r = ring_r[co % slots]
                    d = ring_u[co % uslots] - coef2 * r * acc
                    dx[:, co, cols] = (torch.where(r > 0, d, 0.0) if relu
                                       else d)
    return dx.reshape(x.shape).to(x.dtype)


_BETAS = (0.75, 0.5, 1.0, 0.6)


def _walk_case(size):
    """Window ``size``'s case: β, relu, C below / at / above the window
    in turn, every other case in runs of 16 positions (H·W 35: runs of
    16, 16 and 3, the last ending mid-plane)."""
    c = (max(size - 2, 1), size, size + 4)[size % 3]
    return dict(beta=_BETAS[size % 4], relu=size % 5 != 0, c=c,
                run=16 if size % 2 else None)


@pytest.mark.parametrize("size", range(1, 18))
def test_staged_walk_matches_pallas_kernel(size):
    """The staged kernel's arithmetic (``_staged_walk``) against the JAX
    Pallas kernel in interpret mode and against ``lrn_bwd_ref``, f32, at
    windows 1-17 (odd and even; up to 9 the register rings, past it the
    shared-memory slots), H·W 35 (odd), relu on and off, β 0.75 / 0.5 / 1
    / 0.6: the file's f32 tolerances."""
    case = _walk_case(size)
    rs = np.random.default_rng(100 + size)
    shape = (2, case["c"], 5, 7)
    x = (1.5 * rs.standard_normal(shape)).astype(np.float32)
    ct = rs.standard_normal(shape).astype(np.float32)
    args = dict(alpha=0.5, beta=case["beta"], k=1.0)
    _, jdx = _jax_fwd_grad(lambda v: plrn.lrn(
        v, size, args["alpha"], args["beta"], args["k"], True,
        case["relu"]), jnp.asarray(x), jnp.asarray(ct))
    tx, tct = torch.as_tensor(x), torch.as_tensor(ct)
    got = _staged_walk(tct, tx, size, relu=case["relu"], run=case["run"],
                       **args)
    _hold(got, jdx, 1e-5, 1e-5, "staged walk vs Pallas dx")
    _hold(got, tlrn.lrn_bwd_ref(tct, tx, size, relu=case["relu"], **args)
          .numpy(), 1e-5, 1e-5, "staged walk vs lrn_bwd_ref")


@pytest.mark.parametrize("size,shape", [(5, (2, 7, 27, 27)),
                                        (11, (1, 12, 55, 55))])
def test_staged_walk_in_bf16_on_odd_planes(size, shape):
    """bf16 at AlexNet's odd planes (27 x 27, 55 x 55): the kernel's own
    runs (``run_positions``: 368 of 729 positions in registers, 440 of
    3025 in slots, the last run ending mid-plane), against the Pallas
    kernel at the file's
    bf16 tolerance and against ``lrn_bwd_ref`` (the same f32 values
    rounded once: one bf16 step)."""
    rs = np.random.default_rng(size)
    x = (1.5 * rs.standard_normal(shape)).astype(np.float32)
    ct = rs.standard_normal(shape).astype(np.float32)
    tx = torch.as_tensor(x).bfloat16()
    tct = torch.as_tensor(ct).bfloat16()
    p = tlrn.run_positions(shape[2] * shape[3], torch.bfloat16, size,
                           shape[1])
    assert shape[2] * shape[3] % p != 0 and p % 8 == 0
    _, jdx = _jax_fwd_grad(lambda v: plrn.lrn(
        v, size, 0.5, 0.75, 1.0, True, True),
        jnp.asarray(tx.float().numpy(), jnp.bfloat16),
        jnp.asarray(tct.float().numpy(), jnp.bfloat16))
    got = _staged_walk(tct, tx, size, 0.5, 0.75, 1.0, True)
    assert got.dtype == torch.bfloat16
    _hold(got, np.asarray(jdx, np.float32), 2 ** -7, 1e-4,
          "staged walk vs Pallas dx")
    _hold(got, tlrn.lrn_bwd_ref(tct, tx, size, 0.5, 0.75, 1.0, True)
          .float().numpy(), 2 ** -7, 1e-4, "staged walk vs lrn_bwd_ref")


# --------------------------------------------------------------------------
# the tiled walk past window 9 (csrc/lrn.cu, lrn_tiled_kernel and
# lrn_bwd_tiled_kernel) on the CPU
# --------------------------------------------------------------------------

def _group_sums(rows, cbs, a, b, m, span):
    """The m accumulators of each thread group of a tile (channels cb ..
    cb + m - 1 for cb in ``cbs``), the groups walking side by side: at
    step d each reads row cb - a + d of its span once and adds it into
    every accumulator whose window [cb + i - a, cb + i + b] ∩ [0, C)
    holds it, so each sum starts at its first in-range term and runs in
    channel order. ``rows``: what each channel's row adds (r², or t),
    channels first; a read outside the staged ``span`` fails."""
    c = rows.shape[0]
    cbs = torch.as_tensor(cbs)
    i = torch.arange(m)
    acc = torch.zeros((len(cbs), m) + rows.shape[1:])
    ones = [1] * (rows.dim() - 1)
    for rel in range(-a, m + b):
        j = cbs + rel
        valid = (j >= 0) & (j < c)
        assert bool(((j[valid] >= span[0]) & (j[valid] <= span[1])).all())
        take = valid[:, None] & ((i >= rel - b) & (i <= rel + a))[None]
        v = rows[j.clamp(0, c - 1)][:, None]
        acc = torch.where(take.view(*take.shape, *ones), acc + v, acc)
    return acc.flatten(0, 1)


def _tiled_walk(g, x, size, alpha, beta, k, relu, ct=None, m=8, run=None,
                form=None):
    """The tiled walk in its order, in f32: y and dx. Runs of P positions
    (``walk_plan`` / ``bwd_plan``, or ``run``), tiles of CT output channels
    (or ``ct``), groups of ``m`` channels each summing its windows over its
    tile's staged span (:func:`_group_sums`). The forward: y = r·s^-β.
    The backward, one launch (``form`` "one", the default where
    ``bwd_plan`` fits a tile): phase A sums s of the t-groups q = qmin ..
    qmax around the tile (held bit for bit to the forward's: the same
    window in the same order), t = g·r·s^-β/s of them and u = g·s^-β of
    the tile's own channels; phase B dx = u - (2αβ/n)·r·Σ_adj t over the
    tile's t rows only (the others NaN); two launches ("two"): t and u of
    every channel, then dx by tiles of the forward's plan. The powers are
    taken once over whole tensors (CPU pow rounds its vector body and its
    tail differently). Both outputs round once to x's dtype."""
    n, c, h, w = x.shape
    hw = h * w
    r = x.float().reshape(n, c, hw).transpose(0, 1)     # channels first
    if relu:
        r = torch.where(r < 0, 0.0, r)
    gf = g.float().reshape(n, c, hw).transpose(0, 1)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    coef, coef2 = alpha / size, 2.0 * alpha * beta / size
    fplan = tlrn.walk_plan(x.dtype, x.shape, size)
    bplan = tlrn.bwd_plan(x.dtype, x.shape, size)
    form = form or ("one" if bplan["CT"] else "two")
    s = torch.full_like(r, float("nan"))
    dx = s.clone()

    def tiles(p, ct):
        for p0 in range(0, hw, p):
            cols = slice(p0, min(p0 + p, hw))
            for c0 in range(0, c, ct):
                yield cols, c0, list(range(c0, min(c0 + ct, c), m))

    def groups(cbs, acc):
        for cb, a in zip(cbs, acc.split(m)):
            e = min(cb + m, c)
            yield cb, e, a[:e - cb]

    def dx_of(cols, cbs, acc, u):
        for cb, e, a in groups(cbs, acc):
            rc = r[cb:e, :, cols]
            d = u[cb:e, :, cols] - coef2 * rc * a
            dx[cb:e, :, cols] = torch.where(rc > 0, d, 0.0) if relu else d

    # the forward's window sums
    fct = ct or fplan["CT"]
    for cols, c0, cbs in tiles(run or fplan["P"], fct):
        rr = r[:, :, cols]
        acc = _group_sums(rr * rr, cbs, lo, hi, m,
                          (max(c0 - lo, 0), c0 + fct - 1 + hi))
        for cb, e, a in groups(cbs, acc):
            s[cb:e, :, cols] = k + coef * a
    y = r * pow_neg_beta(s, beta)
    b, bs = _pow_pair(s, beta)
    t_all, u_all = gf * r * bs, gf * b
    if form == "two":
        for cols, c0, cbs in tiles(run or fplan["P"], fct):
            acc = _group_sums(t_all[:, :, cols], cbs, hi, lo, m,
                              (max(c0 - hi, 0), c0 + fct - 1 + lo))
            dx_of(cols, cbs, acc, u_all)
    else:
        bct = ct or bplan["CT"]
        for cols, c0, cbs in tiles(run or bplan["P"], bct):
            rr = r[:, :, cols]
            qmin = -min(-(-hi // m), c0 // m)
            qmax = (min(c0 + bct - 1 + lo, c - 1) - c0) // m
            jbs = [c0 + q * m for q in range(qmin, qmax + 1)]
            acc = _group_sums(rr * rr, jbs, lo, hi, m,    # phase A
                              (max(jbs[0] - lo, 0), jbs[-1] + m - 1 + hi))
            t = torch.full_like(rr, float("nan"))
            for jb, e, a in groups(jbs, acc):
                assert torch.equal(k + coef * a, s[jb:e, :, cols])
                t[jb:e] = t_all[jb:e, :, cols]
            acc = _group_sums(t, cbs, hi, lo, m,          # phase B
                              (jbs[0], jbs[-1] + m - 1))
            dx_of(cols, cbs, acc, u_all)
    back = (lambda v: v.transpose(0, 1).reshape(x.shape).to(x.dtype))
    return back(y), back(dx)


#: (window, C, β, relu, run): odd and even windows past 9, C below the
#: window, at it, above it and past one tile, H·W 15 (odd), runs of the
#: plan or of 8 positions (8 and 7)
_TILED_CASES = ((10, 9, 0.75, True, None), (11, 11, 0.5, False, 8),
                (16, 150, 1.0, False, None), (17, 70, 0.6, True, 8),
                (257, 260, 0.75, True, None), (290, 300, 0.5, True, 8))


@pytest.mark.parametrize("size,c,beta,relu,run", _TILED_CASES)
def test_tiled_walk_matches_pallas_kernel(size, c, beta, relu, run):
    """The tiled walk's arithmetic (``_tiled_walk``), f32: bit for bit the
    same as with one tile of all C and one channel a group (the tiling
    changes no sum's order), and the backward's one- and two-launch forms
    bit for bit alike; against the JAX Pallas kernel in interpret mode and
    against ``lrn_ref`` / ``lrn_bwd_ref`` at the file's f32 tolerances."""
    rs = np.random.default_rng(200 + size)
    shape = (2, c, 3, 5)
    x = (1.5 * rs.standard_normal(shape)).astype(np.float32)
    ct = rs.standard_normal(shape).astype(np.float32)
    args = dict(alpha=0.5, beta=beta, k=1.0, relu=relu)
    tx, tct = torch.as_tensor(x), torch.as_tensor(ct)
    y, dx = _tiled_walk(tct, tx, size, run=run, **args)
    y1, dx1 = _tiled_walk(tct, tx, size, ct=-(-c // 8) * 8, m=1, run=run,
                          form="one", **args)
    _, dx2 = _tiled_walk(tct, tx, size, run=run, form="two", **args)
    assert torch.equal(y, y1) and torch.equal(dx, dx1)
    assert torch.equal(dx, dx2)
    jy, jdx = _jax_fwd_grad(lambda v: plrn.lrn(
        v, size, args["alpha"], beta, args["k"], True, relu),
        jnp.asarray(x), jnp.asarray(ct))
    _hold(y, jy, 1e-5, 1e-5, "tiled walk vs Pallas y")
    _hold(dx, jdx, 1e-5, 1e-5, "tiled walk vs Pallas dx")
    _hold(y, tlrn.lrn_ref(tx, size, **args).numpy(), 1e-5, 1e-5,
          "tiled walk vs lrn_ref")
    _hold(dx, tlrn.lrn_bwd_ref(tct, tx, size, **args).numpy(), 1e-5, 1e-5,
          "tiled walk vs lrn_bwd_ref")


#: (dtype, NCHW shape, window, the backward's route)
_ROUTE_CASES = (
    (torch.bfloat16, (256, 192, 56, 56), 5, "staged"),   # norm2
    (torch.float32, (256, 64, 56, 56), 5, "staged"),     # norm1, f32
    (torch.bfloat16, (128, 96, 55, 55), 5, "staged"),    # AlexNet norm1
    (torch.bfloat16, (3, 13, 5, 7), 9, "staged"),
    (torch.bfloat16, (3, 13, 5, 7), 10, "staged"),
    (torch.bfloat16, (32, 192, 56, 56), 11, "staged"),
    (torch.float32, (32, 64, 56, 56), 16, "staged"),
    (torch.float32, (2, 256, 5, 7), 999, "staged"),      # 256 slots: the cap
    (torch.bfloat16, (2, 257, 5, 7), 256, "staged"),
    (torch.bfloat16, (2, 257, 5, 7), 257, "any"),
    (torch.float32, (8, 320, 28, 28), 288, "any"),
    (torch.bfloat16, (2, 1000, 5, 7), 9, "staged"),      # registers: any C
    (torch.float32, (2, 3, 5, 7), 1000, "staged"),       # 3 slots
)


@pytest.mark.parametrize("dtype,shape,size,route", _ROUTE_CASES)
def test_bwd_route_cases(dtype, shape, size, route):
    assert tlrn.bwd_route(dtype, shape, size) == route


def test_route_constants_match_the_c_entry():
    """The mirror's constants and formulas are csrc/lrn.cu's: the register
    ring's widest window, the staged route's cap on min(size, C), its
    run (row bytes, past window 9 shrunk a warp at a time to fit its
    bytes, down to the shortest run; runs as even as 16-byte multiples
    allow), its chunk of channels, the slots of u and its shared memory;
    and ``route_of`` tests the window first, then the slots against the
    cap."""
    src = (Path(tlrn.__file__).resolve().parents[1] / "csrc"
           / "lrn.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    def body(head):
        part = src[src.index(head):]
        return " ".join(part[:part.index("\n}\n")].split())
    assert const("kMaxSize") == tlrn._RING_MAX
    assert const("kRowBytes") == tlrn._ROW_BYTES
    assert const("kStages") == tlrn._STAGES
    assert const("kChunk") == tlrn._CHUNK
    assert const("kBarBytes") == tlrn._BAR_BYTES
    assert const("kSmemMax") == tlrn._SMEM_MAX
    assert const("kAnyRunMin") == tlrn._ANY_RUN_MIN
    assert const("kAnyCtaBytes") == tlrn._ANY_CTA_BYTES
    assert const("kSlotChunk") == tlrn._SLOT_CHUNK
    assert const("kAnyMaxSlots") == tlrn._ANY_MAX_SLOTS
    assert "constexpr int kRouteStaged = 0, kRouteAny = 1;" in src
    assert tlrn._ROUTES == ("staged", "any")
    route_of = body("int route_of(int C, int size) {")
    assert ("if (size <= kMaxSize) return kRouteStaged; return (size < C ? "
            "size : C) <= kAnyMaxSlots ? kRouteStaged : kRouteAny;"
            in route_of)
    assert ("return size == 0 || size > kMaxSize ? kSlotChunk : size * "
            "((kChunk + size - 1) / size);"
            in body("__host__ __device__ constexpr int chunk_of("))
    assert ("return (P * elt + 16 - elt + 15) / 16 * 16;"
            in body("constexpr int row_bytes("))
    assert ("return (P * elt / 4 + 31) / 32 * 32;"
            in body("constexpr int consumers_of("))
    assert ("return (size - 1) / 2 + 1 < L ? (size - 1) / 2 + 1 : L;"
            in body("constexpr int u_slots("))
    assert ("return kBarBytes + (int64_t)kStages * 2 * chunk_of(size) * "
            "row_bytes(P, elt) + (size > kMaxSize ? (int64_t)(2 * L + "
            "u_slots(size, L)) * consumers_of(P, elt) * (4 / elt) * 4 : 0);"
            in body("constexpr int64_t staged_smem("))
    cap = body("int run_cap(int elt, int size, int L) {")
    assert ("int cap = kRowBytes / elt; if (size <= kMaxSize) return cap; "
            "while (cap > kAnyRunMin && staged_smem(cap, elt, size, L) > "
            "kAnyCtaBytes) cap -= 32 * (4 / elt); return cap;" in cap)
    assert ("const int64_t runs = (HW + cap - 1) / cap, a = 16 / elt; "
            "return ((HW + runs - 1) / runs + a - 1) / a * a;"
            in body("int64_t run_len(int64_t HW, int cap, int elt) {"))
    # the C entry reports the route it takes, from route_of
    entry = body('extern "C" int bigdl_lrn_bwd(')
    assert "const int r = route_of(C, size);" in entry
    assert "if (route != nullptr) *route = r;" in entry
    # the tiled walk past window 9: its settings, its two launch plans
    # (walk_plan, bwd_plan) and the scratch only where no tile fits
    assert const("kWalkM") == tlrn._WALK_M
    assert const("kWalkTile") == tlrn._WALK_TILE
    assert const("kWalkWarps") == tlrn._WALK_WARPS
    assert const("kWalkMinCtas") == tlrn._WALK_MIN_CTAS
    assert const("kWalkChunk") == tlrn._WALK_CHUNK
    assert const("kWalkGroups") == tlrn._WALK_GROUPS
    assert const("kWalkCtaBytes") == tlrn._WALK_CTA_BYTES
    assert ("return (16 * S + 127) / 128 * 128;"
            in body("__host__ __device__ constexpr int walk_bar_bytes("))
    plan = body("Plan walk_plan(")
    for line in ("p.CT = (C + kWalkM - 1) / kWalkM * kWalkM; if (p.CT > "
                 "kWalkTile) p.CT = kWalkTile; p.tiles = (C + p.CT - 1) / "
                 "p.CT; p.W = kWalkWarps;",
                 "while (p.W > 1 && (int64_t)N * ((HW + 32 * (4 / telt) * "
                 "p.W - 1) / (32 * (4 / telt) * p.W)) * p.tiles < "
                 "kWalkMinCtas) p.W /= 2; p.P = 32 * (4 / telt) * p.W;",
                 "p.rb = row_bytes(p.P, selt); const int rows = C < p.CT + "
                 "size - 1 ? C : p.CT + size - 1; p.S = (rows + kWalkChunk "
                 "- 1) / kWalkChunk; p.bufs = walk_bar_bytes(2 * p.S) + "
                 "(int64_t)2 * p.S * kWalkChunk * p.rb <= kWalkCtaBytes ? 2 "
                 ": 1; while (p.S > 2 && walk_bar_bytes(p.bufs * p.S) + "
                 "(int64_t)p.bufs * p.S * kWalkChunk * p.rb > kWalkCtaBytes)"
                 " --p.S;"):
        assert line in plan, line
    plan = body("Plan bwd_plan(")
    for line in ("Plan p{1, 32 * (4 / elt), 0, 0, row_bytes(32 * (4 / elt), "
                 "elt), 0, 1, 0, 0}; const int groups = (C + M - 1) / M; for "
                 "(int ct = groups * M; ct >= M; ct -= M) {",
                 "const int span = (hi + M - 1) / M + (ct - 1 + lo) / M + 1;"
                 " const int trows = M * (span < groups ? span : groups); "
                 "const int xrows = C < trows + size - 1 ? C : trows + size "
                 "- 1; const int S = (xrows + K - 1) / K; const int64_t "
                 "smem = walk_bar_bytes(S) + (int64_t)S * K * p.rb + "
                 "(int64_t)(trows + ct) * p.P * 4; if (smem <= kSmemMax) {",
                 "p.W = trows / M < kWalkGroups ? trows / M : kWalkGroups;"):
        assert line in plan, line
    launch = body("int launch_any(")
    assert ("if (p.CT == 0) { if (a.scratch == nullptr) return -5;"
            in launch)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_staged_runs_fit(dtype):
    """Every run ``run_positions`` picks is whole 16-byte chunks, at most
    the row cap, covers its plane in the fewest runs of its cap, and its
    CTA fits a block's shared memory, up to the cap's 256 slots (the cap
    fits the shortest run: ``static_assert`` in csrc/lrn.cu); past window
    9 it fits 116,224 bytes wherever a run longer than the shortest
    does."""
    elt = dtype.itemsize
    for hw in (1, 7, 35, 64, 448, 449, 729, 3025, 3136, 50176):
        for size, c in ((1, 3), (5, 192), (9, 64), (10, 13), (11, 192),
                        (16, 64), (64, 300), (300, 256), (5000, 200)):
            p = tlrn.run_positions(hw, dtype, size, c)
            assert p % (16 // elt) == 0 and p <= tlrn._ROW_BYTES // elt
            slots = min(size, c) if size > 9 else size
            smem = tlrn.staged_smem(p, elt, size, slots)
            assert smem <= tlrn._SMEM_MAX
            if size > 9 and p > tlrn._ANY_RUN_MIN:
                assert smem <= tlrn._ANY_CTA_BYTES
    assert tlrn.staged_smem(tlrn._ANY_RUN_MIN, elt, 2 * tlrn._ANY_MAX_SLOTS,
                            tlrn._ANY_MAX_SLOTS) <= tlrn._SMEM_MAX


def test_c_entries_match_their_binding():
    """``_kernel_fns`` binds each C entry with ``_ARGTYPES``, held here to
    the parameter lists of ``bigdl_lrn_fwd`` and ``bigdl_lrn_bwd`` in
    csrc/lrn.cu (the backward's scratch pointer among them)."""
    import ctypes
    src = (Path(tlrn.__file__).resolve().parents[1] / "csrc"
           / "lrn.cu").read_text()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "int*": ctypes.POINTER(ctypes.c_int)}
    for name in ("fwd", "bwd"):
        head = src[src.index(f'extern "C" int bigdl_lrn_{name}('):]
        params = head[head.index("(") + 1:head.index(")")].split(",")
        want = []
        for param in params:
            words = param.replace("*", " * ").split()[:-1]
            pointer = "*" in words
            base = [w for w in words if w not in ("const", "*")][0]
            want.append(kinds["int*"] if pointer and base == "int" else
                        ctypes.c_void_p if pointer else kinds[base])
        assert tlrn._ARGTYPES[name] == want, name
    assert "float* scratch" in src[src.index('extern "C" int bigdl_lrn_bwd('):]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_walk_plans_fit(dtype):
    """Every plan of the tiled walk fits its launch: a forward CTA's
    threads (32 a warp, a producer and CT/8 groups of W warps) within the
    kernels' bound of 544, its span staged whole or through a ring of at
    least 2 chunks within 116,224 bytes; the one-launch backward's span,
    t rows and u rows within a block's shared memory; the scratch only
    where no tile fits, and only on the "any" route."""
    elt = dtype.itemsize
    for shape, size in (((8, 320, 28, 28), 288), ((32, 192, 56, 56), 11),
                        ((32, 64, 56, 56), 16), ((3, 300, 5, 7), 290),
                        ((2, 1100, 7, 9), 300), ((4, 264, 14, 14), 1001),
                        ((1, 2048, 3, 5), 1500), ((3, 13, 5, 7), 10),
                        ((2, 257, 3, 3), 257), ((1, 9000, 2, 2), 9000)):
        for staged in (None, torch.float32):
            p = tlrn.walk_plan(dtype, shape, size, staged)
            assert 32 * (1 + p["CT"] // tlrn._WALK_M * p["W"]) <= 544
            assert p["slots"] >= 2 or p["slots"] * tlrn._WALK_CHUNK >= min(
                shape[1], p["CT"] + size - 1)
            assert p["smem"] <= tlrn._WALK_CTA_BYTES
            assert p["P"] == 32 * (4 // elt) * p["W"]
            # two buffers only where each holds the whole span
            assert p["bufs"] == 1 or p["slots"] * tlrn._WALK_CHUNK >= min(
                shape[1], p["CT"] + size - 1)
        b = tlrn.bwd_plan(dtype, shape, size)
        scratch = tlrn.any_scratch(dtype, shape, size)
        assert scratch == (b["CT"] == 0 and tlrn.bwd_route(
            dtype, shape, size) == "any")
        if b["CT"]:
            assert b["smem"] <= tlrn._SMEM_MAX and b["CT"] % 8 == 0
            assert 32 * (1 + b["warps"]) <= 544
    # the issue's rows: one launch of all C at past_cap, the scratch only
    # past the cap (a span no tile fits)
    assert tlrn.bwd_plan(dtype, (8, 320, 28, 28), 288)["CT"] == 320
    assert tlrn.any_scratch(dtype, (1, 2048, 3, 5), 1500)
    assert not tlrn.any_scratch(dtype, (2, 1100, 7, 9), 300)

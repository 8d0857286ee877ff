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
    even sizes (which the card's runtime-size kernels past 9 take too):
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

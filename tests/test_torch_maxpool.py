"""The port's 3x3 / stride-1 / SAME max-pool backward
(bigdl_tpu_torch.ops.maxpool) against the JAX package's Pallas kernel
(``bigdl_tpu/ops/pallas/maxpool.py``) in interpret mode, built as
``tests/test_maxpool_kernel.py`` builds its cases: small-integer x, so
windows hold ties, and integer cotangents, so every sum is exact and the
two must agree bit for bit (first-max tie rule in row-major window
order). Random-normal f32 cases are bit-exact too: both sides add the
nine contributions in the same order in f32. The plain version is also
held bit for bit against the library's max-pool backward, which takes
the same first maximum.

Out-of-image x takes float32's lowest finite value, as in the JAX kernel
(``maxpool.py:90``), not -inf: where a window's in-image maximum is
-inf, -inf padding would match first at a padded position and drop that
window's cotangent, while the JAX kernel (and the library) send it to
the window's first in-image position. ``test_fill_cases_bitexact_vs_
pallas_kernel`` holds planes of -inf and NaN against the JAX kernel;
``_two_stage`` is the Hopper kernel's arithmetic (each window's first
maximum found once, then gathered), held against both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu.ops.pallas.maxpool import maxpool3x3s1 as jmaxpool
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.ops import maxpool as tmp

# the in-block pools' planes (28, 14 and 7: H-tiled, 2-row and
# whole-plane in the TPU kernel) and an odd W; C a multiple of 8, as the
# TPU kernel needs
GEOMETRIES = [(2, 8, 28, 28), (2, 16, 14, 14), (3, 8, 7, 7), (2, 8, 12, 9)]


def _case(shape, seed, dtype, ties=True):
    rs = np.random.default_rng(seed)
    if ties:
        x = rs.integers(0, 4, size=shape).astype(np.float32)
        g = rs.integers(-8, 9, size=shape).astype(np.float32)
    else:
        x = rs.standard_normal(shape).astype(np.float32)
        g = rs.standard_normal(shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (jnp.asarray(x, jd), jnp.asarray(g, jd), torch.as_tensor(x).to(td),
            torch.as_tensor(g).to(td))


def _jax_dx(x, g):
    _, vjp = jax.vjp(lambda v: jmaxpool(v, True), x)
    return np.asarray(vjp(g)[0].astype(jnp.float32))


def _fill_case(kind, shape, seed, dtype):
    """Tied integers with -inf or NaN planted (``kind``: "all_neginf",
    "part_neginf" (60 %), "nan" (10 %)) and integer cotangents."""
    rs = np.random.default_rng(seed)
    x = rs.integers(0, 4, size=shape).astype(np.float32)
    if kind == "all_neginf":
        x[...] = -np.inf
    elif kind == "part_neginf":
        x[rs.random(shape) < 0.6] = -np.inf
    else:
        x[rs.random(shape) < 0.1] = np.nan
    g = rs.integers(-8, 9, size=shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (jnp.asarray(x, jd), jnp.asarray(g, jd), torch.as_tensor(x).to(td),
            torch.as_tensor(g).to(td))


def _bits(a):
    """float32 bit patterns (bit-for-bit comparison, signed zeros too)."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _two_stage(x, y, dy):
    """The Hopper kernel's arithmetic (``csrc/maxpool.cu``) in torch.
    Stage 1: for each window o, the offset 0..8 of its first position in
    row-major order where x == y[o], out-of-image x the fill value
    (compared, not skipped), 9 where nothing matches (NaN). Stage 2: each
    output p adds dy[o] over the windows whose offset points at p, in the
    plain version's (dr, dc) order, in f32 from 0.0, rounded once."""
    n, c, h, w = x.shape
    fill = torch.finfo(torch.float32).min
    xp = F.pad(x.float(), (1, 1, 1, 1), value=fill)
    yf = y.float()
    off = torch.full(x.shape, 9, dtype=torch.uint8)
    for f in reversed(range(9)):        # the lowest matching offset wins
        r, s = divmod(f, 3)
        off[xp[:, :, r:r + h, s:s + w] == yf] = f
    offp = torch.full((n, c, h + 2, w + 2), 15, dtype=torch.uint8)
    offp[:, :, 1:-1, 1:-1] = off
    gp = F.pad(dy.float(), (1, 1, 1, 1))
    acc = torch.zeros(x.shape, dtype=torch.float32)
    for q in range(9):          # p at offset (dr, dc) of o = p - (dr, dc)
        dr, dc = q // 3 - 1, q % 3 - 1
        win = (slice(None), slice(None), slice(1 - dr, 1 - dr + h),
               slice(1 - dc, 1 - dc + w))
        acc = torch.where(offp[win] == q, acc + gp[win], acc)
    return acc.to(x.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", GEOMETRIES)
def test_backward_bitexact_vs_pallas_kernel(shape, dtype):
    jx, jg, tx, tg = _case(shape, 1, dtype)
    y = F.max_pool2d(tx, 3, 1, 1)
    dx = tmp.maxpool3x3s1_bwd(tx, y, tg)
    assert dx.dtype == tx.dtype
    np.testing.assert_array_equal(dx.float().numpy(), _jax_dx(jx, jg))


FILL_CASES = [("all_neginf", (1, 8, 5, 5)), ("part_neginf", (1, 8, 6, 6)),
              ("nan", (1, 8, 6, 6)), ("part_neginf", (2, 8, 12, 9))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,shape", FILL_CASES)
def test_fill_cases_bitexact_vs_pallas_kernel(kind, shape, dtype):
    """-inf and NaN planes: the port's dx is the JAX kernel's, bit for
    bit (all -inf: every window's cotangent reaches its first in-image
    position, sum of dx = sum of dy)."""
    jx, jg, tx, tg = _fill_case(kind, shape, 4, dtype)
    dx = tmp.maxpool3x3s1_bwd(tx, F.max_pool2d(tx, 3, 1, 1), tg)
    np.testing.assert_array_equal(_bits(dx.float()), _bits(_jax_dx(jx, jg)))
    if kind == "all_neginf":
        assert float(dx.float().sum()) == float(tg.float().sum())


TWO_STAGE_CASES = ([("ties", s) for s in GEOMETRIES]
                   + [(k, s) for k, s in FILL_CASES[:3]]
                   + [("ties", (1, 8, 37, 23)), ("nan", (1, 8, 37, 23))])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind,shape", TWO_STAGE_CASES)
def test_two_stage_model_bitexact(kind, shape, dtype):
    """The kernel's two stages (first-max offset per window, then the
    gather) compute the JAX kernel's function and the plain version's,
    bit for bit."""
    jx, jg, tx, tg = (_case(shape, 5, dtype) if kind == "ties"
                      else _fill_case(kind, shape, 5, dtype))
    y = F.max_pool2d(tx, 3, 1, 1)
    got = _two_stage(tx, y, tg)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(got.float()), _bits(_jax_dx(jx, jg)))
    np.testing.assert_array_equal(
        _bits(got.float()),
        _bits(tmp.maxpool3x3s1_bwd_ref(tx, y, tg).float()))


def test_two_stage_model_bitexact_random_f32():
    """Random normals in f32 (sums rounded at every step): the model and
    the plain version add the same terms in the same order."""
    _, _, tx, tg = _case((2, 8, 37, 23), 6, "f32", ties=False)
    y = F.max_pool2d(tx, 3, 1, 1)
    np.testing.assert_array_equal(
        _bits(_two_stage(tx, y, tg)),
        _bits(tmp.maxpool3x3s1_bwd_ref(tx, y, tg)))


def test_backward_bitexact_random_f32():
    jx, jg, tx, tg = _case(GEOMETRIES[1], 2, "f32", ties=False)
    dx = tmp.maxpool3x3s1_bwd(tx, F.max_pool2d(tx, 3, 1, 1), tg)
    np.testing.assert_array_equal(dx.numpy(), _jax_dx(jx, jg))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_autograd_function_matches_library(dtype):
    """``maxpool3x3s1``: the library forward, and a backward equal to the
    library's on tied windows."""
    _, _, tx, tg = _case((2, 3, 9, 11), 3, dtype)
    xa, xb = tx.clone().requires_grad_(), tx.clone().requires_grad_()
    ya, yb = tmp.maxpool3x3s1(xa), F.max_pool2d(xb, 3, 1, 1)
    assert torch.equal(ya, yb)
    (ga,), (gb,) = (torch.autograd.grad(y, v, tg)
                    for y, v in ((ya, xa), (yb, xb)))
    assert torch.equal(ga, gb)


def test_tie_rule_is_first_max():
    """An all-equal plane sends each window's cotangent to its first
    (row-major) element: the corner collects four windows."""
    x = torch.ones((1, 1, 4, 4))
    dx = tmp.maxpool3x3s1_bwd(x, F.max_pool2d(x, 3, 1, 1), torch.ones_like(x))
    assert dx[0, 0, 0, 0] == 4.0 and dx.sum() == 16.0


def test_spatial_max_pooling_does_not_dispatch_it():
    """Opt-in, as in the JAX package: the module's backward is the
    library's and no launch is counted."""
    before = tmp.bwd_launches
    x = torch.randn((2, 8, 7, 7), requires_grad=True)
    y = tnn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil()(x)
    assert "MaxPool2D" in type(y.grad_fn).__name__
    y.sum().backward()
    assert tmp.bwd_launches == before

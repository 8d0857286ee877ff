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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", GEOMETRIES)
def test_backward_bitexact_vs_pallas_kernel(shape, dtype):
    jx, jg, tx, tg = _case(shape, 1, dtype)
    y = F.max_pool2d(tx, 3, 1, 1)
    dx = tmp.maxpool3x3s1_bwd(tx, y, tg)
    assert dx.dtype == tx.dtype
    np.testing.assert_array_equal(dx.float().numpy(), _jax_dx(jx, jg))


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

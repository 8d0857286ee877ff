"""The port's fused LM-head cross-entropy (bigdl_tpu_torch.ops.fused_ce)
against the JAX package's Pallas kernel, run as its own tests run it on
the CPU (``use_kernel=True, interpret=True``), and against its XLA path
(``use_kernel=False``).

On the CPU the port's wrappers take their plain versions
(``fused_ce_fwd_ref``, ``fused_ce_dh_ref``, ``fused_ce_dw_ref``) inside
the same ``autograd.Function`` the card runs, so these tests hold the
yardsticks that ``chip_smoke.py`` compares the CUDA kernels with to the
JAX kernels, values and gradients.

Tolerances. float32: rtol 2e-5 (atol 1e-6 on the gradients, whose
smallest elements are near 0): the same math, sums in another order.
bfloat16 (h and W in bf16, the bias f32): the loss is f32 on both sides
and differs in summation order only (rtol 1e-5); dh and dW come out in
bf16, and a sum that lands near a rounding boundary may round to the
neighbouring bf16 value on one side, one step of 2^-8 relative, so they
are held at rtol 2^-7 plus atol 2^-7·max|grad|; db stays f32 (rtol
2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas import fused_ce as jce
from bigdl_tpu_torch.ops import fused_ce as tce


def _case(n=256, d=128, v=512, seed=0):
    rs = np.random.default_rng(seed)
    h = (0.5 * rs.standard_normal((n, d))).astype(np.float32)
    w = (0.5 * rs.standard_normal((v, d)) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rs.standard_normal((v,))).astype(np.float32)
    t = rs.integers(1, v + 1, size=(n,)).astype(np.int32)
    return h, w, b, t


_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_value_and_grads(h, w, b, t, jdt, reduction="mean", **kw):
    """Loss and (dh, dw[, db]) of the JAX function, as float32 numpy."""
    args = [jnp.asarray(h, jdt), jnp.asarray(w, jdt)]
    if b is not None:
        args.append(jnp.asarray(b))

    def f(*a):
        bias = a[2] if b is not None else None
        return jce.linear_cross_entropy(a[0], a[1], bias, jnp.asarray(t),
                                        reduction=reduction, **kw)

    loss, grads = jax.value_and_grad(f, argnums=tuple(range(len(args))))(
        *args)
    return float(loss), [np.asarray(jnp.asarray(g, jnp.float32))
                         for g in grads]


def _torch_value_and_grads(h, w, b, t, tdt, reduction="mean", **kw):
    args = [torch.from_numpy(h).to(tdt).requires_grad_(),
            torch.from_numpy(w).to(tdt).requires_grad_()]
    if b is not None:
        args.append(torch.from_numpy(b).requires_grad_())
    loss = tce.linear_cross_entropy(args[0], args[1],
                                    args[2] if b is not None else None,
                                    torch.from_numpy(t),
                                    reduction=reduction, **kw)
    grads = torch.autograd.grad(loss, args)
    for a, g in zip(args, grads):
        assert g.dtype == a.dtype and g.shape == a.shape
    return float(loss.detach()), [g.float().numpy() for g in grads]


def _grad_close(got, want, dtype, what):
    if dtype == "f32" or what == "db":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matches_jax_interpret_kernel(dtype, reduction):
    """Loss and the gradients of h, W and b at (N, D, V) = (256, 128,
    512) against the interpret-mode Pallas kernel."""
    jdt, tdt = _DTYPES[dtype]
    h, w, b, t = _case()
    jl, jg = _jax_value_and_grads(h, w, b, t, jdt, reduction,
                                  use_kernel=True, interpret=True)
    tl, tg = _torch_value_and_grads(h, w, b, t, tdt, reduction)
    np.testing.assert_allclose(tl, jl, rtol=2e-5 if dtype == "f32"
                               else 1e-5)
    for what, got, want in zip(("dh", "dw", "db"), tg, jg):
        _grad_close(got, want, dtype, what)


def test_ragged_bf16_matches_jax_interpret_kernel():
    """The geometry the bf16 forward masks on the card: N 130 (no
    multiple of its 128 rows), V 300 (no multiple of its 256 columns), D
    72 (one 64-column box and 8 columns of a second) and one target 0,
    against the interpret-mode Pallas kernel. That kernel takes only
    tile-divisible shapes, so it runs the same problem padded to h (256,
    128) and W (384, 128): zero feature columns add no product terms,
    padded vocab rows carry a bias of -1e30 (exp 0 in every lse, no dW or
    db) and padded token rows a zero cotangent (no share of dh, dW or
    db). Per-row nll and lse, the mean loss and the unpadded gradients
    are compared: nll and lse at rtol 1e-5 (f32 sums in another order),
    the gradients as in ``_grad_close``."""
    n, d, v = 130, 72, 300
    h, w, b, t = _case(n=n, d=d, v=v, seed=5)
    t[17] = 0
    hp = np.zeros((256, 128), np.float32)
    hp[:n, :d] = h
    wp = np.zeros((384, 128), np.float32)
    wp[:v, :d] = w
    bp = np.full(384, -1e30, np.float32)
    bp[:v] = b
    tp = np.ones(256, np.int32)
    tp[:n] = t
    mask = jnp.asarray(np.arange(256) < n, jnp.float32)
    targets = jnp.asarray(tp)

    def f(hh, ww, bb):
        nll = jce._linear_ce(hh, ww, bb, targets, True)
        return jnp.sum(nll * mask) / n

    args = (jnp.asarray(hp, jnp.bfloat16), jnp.asarray(wp, jnp.bfloat16),
            jnp.asarray(bp))
    jl, jg = jax.value_and_grad(f, argnums=(0, 1, 2))(*args)
    jnll, jlse = jce._forward(*args, targets, True)
    jdh, jdw, jdb = (np.asarray(jnp.asarray(g, jnp.float32)) for g in jg)

    tl, (tdh, tdw, tdb) = _torch_value_and_grads(h, w, b, t, torch.bfloat16)
    tnll, tlse = tce.fused_ce_fwd_ref(
        torch.from_numpy(h).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b),
        torch.from_numpy(t))
    np.testing.assert_allclose(tnll.numpy(), np.asarray(jnll)[:n],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:n, 0],
                               rtol=1e-5, atol=1e-5)
    assert tnll[17] == tlse[17]
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    for what, got, want in (("dh", tdh, jdh[:n, :d]), ("dw", tdw, jdw[:v, :d]),
                            ("db", tdb, jdb[:v])):
        _grad_close(got, want, "bf16", what)


def test_no_bias_matches_jax():
    h, w, _, t = _case(seed=1)
    jl, jg = _jax_value_and_grads(h, w, None, t, jnp.float32,
                                  use_kernel=True, interpret=True)
    tl, tg = _torch_value_and_grads(h, w, None, t, torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    for what, got, want in zip(("dh", "dw"), tg, jg):
        _grad_close(got, want, "f32", what)


@pytest.mark.parametrize("bad", [0, 600])    # below 1 / above V = 512
def test_out_of_contract_targets_match_jax(bad):
    """A quarter of the targets out of [1, V]: their nll is lse and their
    one-hot zero, on both sides."""
    h, w, b, t = _case(seed=2)
    t[:64] = bad
    jl, jg = _jax_value_and_grads(h, w, b, t, jnp.float32, use_kernel=True,
                                  interpret=True)
    tl, tg = _torch_value_and_grads(h, w, b, t, torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    for what, got, want in zip(("dh", "dw", "db"), tg, jg):
        _grad_close(got, want, "f32", what)
    nll, lse = tce.fused_ce_fwd_ref(*(torch.from_numpy(x) for x in (h, w, b)),
                                    torch.from_numpy(t))
    torch.testing.assert_close(nll[:64], lse[:64], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_use_kernel_false_matches_jax_xla_path(dtype):
    """The materialised path (``linear_cross_entropy_ref``) against JAX's
    ``use_kernel=False``, with an out-of-contract target among them; in
    bf16 both round the logits to bf16 before adding the f32 bias."""
    jdt, tdt = _DTYPES[dtype]
    h, w, b, t = _case(seed=3)
    t[5] = 0
    jl, jg = _jax_value_and_grads(h, w, b, t, jdt, use_kernel=False)
    tl, tg = _torch_value_and_grads(h, w, b, t, tdt, use_kernel=False)
    np.testing.assert_allclose(tl, jl, rtol=2e-5 if dtype == "f32" else 1e-5)
    for what, got, want in zip(("dh", "dw", "db"), tg, jg):
        _grad_close(got, want, dtype, what)


@pytest.mark.parametrize("v", [300, 50257 // 64])
def test_plain_kernel_versions_agree_with_the_materialised_path(v):
    """The three plain kernel versions, composed by ``_LinearCE``, equal
    autograd through ``linear_cross_entropy_ref`` (f32, N = 100 and V not
    a multiple of 128, one padding target): rtol 2e-5."""
    h, w, b, t = _case(n=100, d=24, v=v, seed=4)
    t[7] = 0
    kl, kg = _torch_value_and_grads(h, w, b, t, torch.float32)
    rl, rg = _torch_value_and_grads(h, w, b, t, torch.float32,
                                    use_kernel=False)
    np.testing.assert_allclose(kl, rl, rtol=2e-5)
    for what, got, want in zip(("dh", "dw", "db"), kg, rg):
        _grad_close(got, want, "f32", what)


def test_cpu_path_counts_no_kernel_launches_and_refuses_bad_calls():
    h, w, b, t = (torch.from_numpy(x) for x in _case(n=16, d=16, v=32))
    before = (tce.fwd_launches, tce.dh_launches, tce.dw_launches)
    hh = h.clone().requires_grad_()
    tce.linear_cross_entropy(hh, w, b, t).backward()
    assert (tce.fwd_launches, tce.dh_launches, tce.dw_launches) == before
    assert tce.linear_ce_supported(h, w)
    # fp16: "auto" on CPU tensors takes the materialised path, True raises
    hb, wb = h.half(), w.half()
    assert not tce.linear_ce_supported(hb, wb)
    want = tce.linear_cross_entropy_ref(hb.float(), wb.float(), b, t)
    got = tce.linear_cross_entropy(hb, wb, b, t)
    torch.testing.assert_close(got.float(), want, rtol=2e-3, atol=0)
    with pytest.raises(ValueError, match="use_kernel=False"):
        tce.linear_cross_entropy(hb, wb, b, t, use_kernel=True)
    # a feature width that is no multiple of 8 is taken, True as well,
    # on h and W zero-padded to one
    hb, wb = h[:, :12], w[:, :12]
    assert tce.linear_ce_supported(hb, wb)
    want = tce.linear_cross_entropy_ref(hb, wb, b, t)
    for mode in ("auto", True):
        got = tce.linear_cross_entropy(hb, wb, b, t, use_kernel=mode)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=0)
    assert (tce.fwd_launches, tce.dh_launches, tce.dw_launches) == before


def test_auto_refuses_unsupported_calls_off_the_cpu():
    """Off the CPU (meta tensors stand in for the card's here), "auto"
    raises where the kernels do not take the call (fp16) instead of
    materialising the logits unseen."""
    h = torch.empty((8, 16), dtype=torch.float16, device="meta")
    w = torch.empty((32, 16), dtype=torch.float16, device="meta")
    t = torch.ones(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="use_kernel=False takes"):
        tce.linear_cross_entropy(h, w, None, t)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_feature_width_100_matches_jax(dtype):
    """D 100, no multiple of 8: the port pads h and W with zero columns to
    104 for the kernels (on CPU tensors their plain versions, inside the
    same autograd function) and autograd slices dh and dW back. f32:
    loss and gradients against JAX's ``linear_cross_entropy`` at D 100,
    which takes its XLA path there (the Pallas kernel needs D % 128 ==
    0), rtol 2e-5 as ``_grad_close``. bf16 (where that path rounds the
    logits to bf16, the kernels do not): against the interpret-mode
    Pallas kernel on the same problem with zero columns to D 128 (exact:
    they add no product terms), the unpadded gradients compared, at the
    file's bf16 tolerances."""
    jdt, tdt = _DTYPES[dtype]
    h, w, b, t = _case(n=256, d=100, v=512, seed=6)
    if dtype == "f32":
        jl, jg = _jax_value_and_grads(h, w, b, t, jdt)
    else:
        hp, wp = (np.pad(x, ((0, 0), (0, 28))) for x in (h, w))
        jl, jg = _jax_value_and_grads(hp, wp, b, t, jdt, use_kernel=True,
                                      interpret=True)
        jg = [jg[0][:, :100], jg[1][:, :100], jg[2]]
    tl, tg = _torch_value_and_grads(h, w, b, t, tdt)
    np.testing.assert_allclose(tl, jl, rtol=2e-5 if dtype == "f32"
                               else 1e-5)
    for what, got, want in zip(("dh", "dw", "db"), tg, jg):
        assert got.shape == want.shape, what
        _grad_close(got, want, dtype, what)

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
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu.ops.pallas import fused_ce as jce
from bigdl_tpu_torch.ops import fused_ce as tce
# the 3xTF32 emulation and the source readers of the flash tests
from test_torch_flash_attention import (_chip_smoke, _function_body,
                                        _mm_1xtf32, _mm_3xtf32)


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
    jl, jnll, jlse, (jdh, jdw, jdb) = _padded_interpret(h, w, b, t, 256, 384,
                                                        128)
    tl, (tdh, tdw, tdb) = _torch_value_and_grads(h, w, b, t, torch.bfloat16)
    tnll, tlse = tce.fused_ce_fwd_ref(
        torch.from_numpy(h).to(torch.bfloat16),
        torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(b),
        torch.from_numpy(t))
    np.testing.assert_allclose(tnll.numpy(), jnll, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), jlse, rtol=1e-5, atol=1e-5)
    assert tnll[17] == tlse[17]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for what, got, want in (("dh", tdh, jdh), ("dw", tdw, jdw),
                            ("db", tdb, jdb)):
        _grad_close(got, want, "bf16", what)


def _padded_interpret(h, w, b, t, n_pad, v_pad, d_pad):
    """The mean loss, per-row nll and lse, and (dh, dW, db) of the
    interpret-mode Pallas kernel in bf16 on a problem it does not tile,
    run padded to h (n_pad, d_pad) and W (v_pad, d_pad): zero feature
    columns add no product terms, padded vocab rows carry a bias of -1e30
    (exp 0 in every lse, no dW or db) and padded token rows a zero
    cotangent (no share of dh, dW or db). All cut back to the problem's
    shapes, as float32 numpy."""
    n, d = h.shape
    v = w.shape[0]
    hp = np.zeros((n_pad, d_pad), np.float32)
    hp[:n, :d] = h
    wp = np.zeros((v_pad, d_pad), np.float32)
    wp[:v, :d] = w
    bp = np.full(v_pad, -1e30, np.float32)
    bp[:v] = b
    tp = np.ones(n_pad, np.int32)
    tp[:n] = t
    mask = jnp.asarray(np.arange(n_pad) < n, jnp.float32)
    targets = jnp.asarray(tp)

    def f(hh, ww, bb):
        nll = jce._linear_ce(hh, ww, bb, targets, True)
        return jnp.sum(nll * mask) / n

    args = (jnp.asarray(hp, jnp.bfloat16), jnp.asarray(wp, jnp.bfloat16),
            jnp.asarray(bp))
    jl, jg = jax.value_and_grad(f, argnums=(0, 1, 2))(*args)
    jnll, jlse = jce._forward(*args, targets, True)
    jdh, jdw, jdb = (np.asarray(jnp.asarray(g, jnp.float32)) for g in jg)
    return (float(jl), np.asarray(jnll)[:n], np.asarray(jlse)[:n, 0],
            (jdh[:n, :d], jdw[:v, :d], jdb[:v]))


def test_bf16_past_d1024_matches_jax_interpret_kernel():
    """bf16 past the cluster kernels' D 1024, where the card runs dh and
    dW/db on the route "tc_chunked": N 24, V 40, D 1032 (one target 0)
    through ``linear_cross_entropy`` (on CPU tensors the plain versions
    inside the same autograd function) against the interpret-mode Pallas
    kernel, which does not tile these shapes and so runs them padded to
    h (128, 1152) and W (128, 1152) (``_padded_interpret``): the loss at
    rtol 1e-5, the gradients as in ``_grad_close``."""
    n, d, v = 24, 1032, 40
    assert tce.kernel_route(torch.bfloat16, d, "dh") == "tc_chunked"
    assert tce.kernel_route(torch.bfloat16, d, "dw") == "tc_chunked"
    h, w, b, t = _case(n=n, d=d, v=v, seed=7)
    t[3] = 0
    jl, _, _, jg = _padded_interpret(h, w, b, t, 128, 128, 1152)
    tl, tg = _torch_value_and_grads(h, w, b, t, torch.bfloat16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for what, got, want in zip(("dh", "dw", "db"), tg, jg):
        assert got.shape == want.shape, what
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


# --------------------------------------------------------------------------
# the f32 kernels on the card (route "tf32"): their arithmetic and dispatch
# --------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parents[1] / "bigdl_tpu_torch" / "csrc"


def _emulated_bwd(h, w, b, t, lse, g, vocab_rows, parts, mm):
    """dh (``vocab_rows`` False) or (dW, db) as ``fce_bwd_tf32_kernel``
    forms them, every product through ``mm``: the logits of resident
    rows R against walked rows X summed over D in score steps of 32
    columns, each step's two K groups of 16 in fresh sums added in f32;
    ``parts`` warpgroups each sum an equal run of steps (4: a cluster's
    two CTAs, each the sum of its two warpgroups, added in rank order;
    2: one CTA's, the logits recomputed by every slice), steps past D
    zero; dl in f32; the output's transpose Xᵀ·dl over walked tiles of 64
    rows, each half tile of 32 rows a fresh sum added in f32; db the sum
    of the unrounded dl."""
    r, x = (w, h) if vocab_rows else (h, w)
    d = x.shape[1]
    nh = -(-(-(-d // 32)) // parts)
    pad = parts * nh * 32 - d
    rp, xp = F.pad(r, (0, pad)), F.pad(x, (0, pad))
    sums = []
    for p in range(parts):
        s = 0
        for c in range(32 * p * nh, 32 * (p + 1) * nh, 16):
            s = s + mm(rp[:, c:c + 16], xp[:, c:c + 16].T)
        sums.append(s)
    s = (sums[0] + sums[1]) + ((sums[2] + sums[3]) if parts == 4 else 0)
    onehot = (torch.arange(w.shape[0])[None, :]
              == (t.long() - 1)[:, None]).float()
    if vocab_rows:
        dl = (torch.exp(s + b[:, None] - lse[None, :]) - onehot.T) * g
    else:
        dl = (torch.exp(s + b[None, :] - lse[:, None]) - onehot) * g[:, None]
    out = torch.zeros((r.shape[0], d))
    for x0 in range(0, x.shape[0], 32):
        out = out + mm(x[x0:x0 + 32].T, dl[:, x0:x0 + 32].T).T
    return (out, dl.sum(dim=1)) if vocab_rows else out


@pytest.mark.parametrize("parts", [4, 2], ids=["cluster", "slice"])
def test_3xtf32_backward_holds_the_f32_limit(parts):
    """The numerical argument of the f32 dh and dW/db on the card (route
    "tf32"): 3xTF32 on the tensor cores, emulated in f32 on the CPU
    (``_emulated_bwd``: the split, fresh sums every 2 K steps of a score
    step and every 4 of an output step, the cluster's halves added in
    rank order, db from the unrounded dl) at D 1024, V 512, N 64 (inputs
    from a numpy seed, as ``chip_smoke._fce_inputs`` scales them), at the
    cluster's split of the logits and at a slice's: dh, dW and db stay
    within ``chip_smoke._FCE_TOL[float32]`` of the function evaluated in
    float64 (measured as ``chip_smoke._worst`` does), while single TF32
    products miss it on dh and dW: TF32 keeps 11 of f32's 24 bits, the
    split about 22."""
    cs = _chip_smoke()
    rtol, atol = cs._FCE_TOL[torch.float32]
    n, v, d = 64, 512, 1024
    rs = np.random.default_rng(20)
    h = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32))
    w = torch.from_numpy((rs.standard_normal((v, d)) / np.sqrt(d))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rs.standard_normal(v)).astype(np.float32))
    t = torch.from_numpy(rs.integers(1, v + 1, size=n).astype(np.int32))
    g = torch.full((n,), 1.0 / n)
    s64 = h.double() @ w.double().T + b.double()
    lse = torch.logsumexp(s64, dim=1).float()
    onehot = (torch.arange(v)[None, :] == (t.long() - 1)[:, None]).double()
    dl64 = (torch.exp(s64 - lse.double()[:, None]) - onehot) * g.double()[
        :, None]
    want = {"dh": dl64 @ w.double(), "dw": dl64.T @ h.double(),
            "db": dl64.sum(dim=0)}
    for mm, holds in ((_mm_3xtf32, True), (_mm_1xtf32, False)):
        got = {"dh": _emulated_bwd(h, w, b, t, lse, g, False, parts, mm)}
        got["dw"], got["db"] = _emulated_bwd(h, w, b, t, lse, g, True, parts,
                                            mm)
        worst = {k: cs._worst(got[k], want[k], rtol if k != "db" else
                              cs._FCE_DB_TOL[0],
                              atol if k != "db" else cs._FCE_DB_TOL[1])[1]
                 for k in want}
        if holds:
            assert max(worst.values()) <= 1, (mm.__name__, worst)
        else:
            assert min(worst["dh"], worst["dw"]) > 1, (mm.__name__, worst)


def _emulated_fwd(h, w, b, t, splits, mm, cols=128):
    """nll and lse as ``fce_fwd_tf32_kernel`` forms them, every product
    through ``mm``: vocab tiles of ``cols`` rows, the logits of a tile
    summed over D in score steps of 32 columns (columns past D zero), each
    step one fresh sum added in f32, plus the bias; the tiles folded into
    each row's online logsumexp (max, sum of exp) and target logit in
    ``splits`` balanced parts of the walk, merged as ``fce_merge_kernel``
    merges them."""
    n, d = h.shape
    v = w.shape[0]
    pad = -d % 32
    hp, wp = F.pad(h, (0, pad)), F.pad(w, (0, pad))
    tiles = -(-v // cols)
    t0 = t.long() - 1
    parts = []
    for z in range(splits):
        m = torch.full((n,), -torch.inf)
        ls, tl = torch.zeros(n), torch.zeros(n)
        for tile in range(z * tiles // splits, (z + 1) * tiles // splits):
            v0, v1 = tile * cols, min(v, tile * cols + cols)
            s = 0
            for c in range(0, d + pad, 32):
                s = s + mm(hp[:, c:c + 32], wp[v0:v1, c:c + 32].T)
            s = s + b[v0:v1]
            hit = (t0 >= v0) & (t0 < v1)
            at = (t0 - v0).clamp(0, v1 - v0 - 1)[:, None]
            tl = tl + torch.where(hit, s.gather(1, at)[:, 0], 0.0)
            m_new = torch.maximum(m, s.max(dim=1).values)
            ls = (ls * torch.exp(m - m_new)
                  + torch.exp(s - m_new[:, None]).sum(dim=1))
            m = m_new
        parts.append((m, ls, tl))
    top = torch.stack([p[0] for p in parts]).max(dim=0).values
    lse = top + torch.log(sum(p[1] * torch.exp(p[0] - top) for p in parts))
    return lse - sum(p[2] for p in parts), lse


@pytest.mark.parametrize("splits", [1, 3])
def test_3xtf32_forward_holds_the_f32_limit(splits):
    """The numerical argument of the f32 forward on the card (route
    "tf32"): 3xTF32 on the tensor cores, emulated in f32 on the CPU
    (``_emulated_fwd``: the split, a fresh sum a score step of 32
    columns, vocab tiles of 128, the online logsumexp and the merge of
    ``splits`` parts of the walk) at D 1024, V 512, N 64 (inputs from a
    numpy seed, as ``chip_smoke._fce_inputs`` scales them, one target 0):
    nll and lse stay within ``chip_smoke._FCE_ABS_TOL`` of the function
    evaluated in float64, while single TF32 products miss it on nll
    (a target logit summed over D keeps TF32's 11 bits)."""
    cs = _chip_smoke()
    n, v, d = 64, 512, 1024
    rs = np.random.default_rng(21)
    h = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32))
    w = torch.from_numpy((rs.standard_normal((v, d)) / np.sqrt(d))
                         .astype(np.float32))
    b = torch.from_numpy((0.1 * rs.standard_normal(v)).astype(np.float32))
    t = torch.from_numpy(rs.integers(1, v + 1, size=n).astype(np.int32))
    t[n // 2] = 0
    s64 = h.double() @ w.double().T + b.double()
    lse64 = torch.logsumexp(s64, dim=1)
    t0 = t.long() - 1
    tl64 = torch.where((t0 >= 0) & (t0 < v),
                       s64.gather(1, t0.clamp(0, v - 1)[:, None])[:, 0], 0.0)
    for mm, holds in ((_mm_3xtf32, True), (_mm_1xtf32, False)):
        nll, lse = _emulated_fwd(h, w, b, t, splits, mm)
        assert nll[n // 2] == lse[n // 2]
        worst = {k: cs._worst(got, want, None, cs._FCE_ABS_TOL)[1]
                 for k, got, want in (("nll", nll, lse64 - tl64),
                                      ("lse", lse, lse64))}
        if holds:
            assert max(worst.values()) <= 1, (mm.__name__, worst)
        else:
            assert worst["nll"] > 1, (mm.__name__, worst)


def test_kernel_route_matches_the_c_dispatch():
    """``kernel_route`` against csrc/fused_ce.cu: ``BIGDL_FCE_DISPATCH``
    takes dtype code 0 as float and 1 as bf16, D a multiple of 8; the
    forward runs ``tc::fwd`` for bf16 and ``tf::fwd`` (which launches
    ``fce_fwd_tf32_kernel``) for f32; dh and dW/db run ``tf::bwd``
    (which launches ``fce_bwd_tf32_kernel``) for f32 at every D,
    ``tc::bwd`` (the cluster kernel) for bf16 where ``clustered`` (D <=
    kRanks · kSlice) and ``tc::chunked`` past it (which launches
    ``fce_dl_tc_kernel`` and ``fce_gemm_tc_kernel`` a chunk at a time;
    the CUDA-core ``fce_bwd_kernel`` is gone); ``bigdl_fce_dh_splits``
    asks ``tf::dh_splits`` for f32 and gives 1 for bf16 past
    ``clustered``, and ``bigdl_fce_fwd_splits`` asks ``tf::fwd_splits``
    for f32. Every width up to 2100 of both dtypes, each at the route of
    the width it is padded to."""
    src = (_CSRC / "fused_ce.cu").read_text()
    macro = src[src.index("#define BIGDL_FCE_DISPATCH"):]
    macro = macro[:macro.index("while (0)")]
    assert "if (D <= 0 || D % 8 != 0) return -1;" in macro
    assert "if (dtype == 0) return FN<float>(__VA_ARGS__);" in macro
    assert "if (dtype == 1) return FN<bf16>(__VA_ARGS__);" in macro
    fwd = _function_body(src, "template <typename T>\nint fwd(")
    assert "if constexpr (sizeof(T) == 4)\n    return tf::fwd(" in fwd
    assert "  else\n    return tc::fwd(" in fwd
    tf_src = src[src.index("namespace tf {"):]
    assert "fce_fwd_tf32_kernel<<<" in _function_body(tf_src, "int fwd(")
    assert "fce_fwd_kernel" not in src.replace("fce_fwd_tf32_kernel", "")
    bwd = _function_body(src, "template <typename T, bool kVocabRows>\nint "
                              "bwd(")
    f32, bf16 = bwd.split("} else {")
    assert "if constexpr (sizeof(T) == 4)" in f32
    assert "return tf::bwd<kVocabRows>(" in f32
    assert "if (clustered<T>(D))\n      return tc::bwd<kVocabRows>(" in bf16
    assert "return tc::chunked<kVocabRows>(" in bf16
    tc_src = src[src.index("namespace tc {"):]
    chunked = _function_body(tc_src, "template <bool kVocabRows>\nint "
                                     "chunked(")
    assert "auto pass1 = fce_dl_tc_kernel<kVocabRows>;" in chunked
    assert "pass1<<<" in chunked and "fce_gemm_tc_kernel<<<" in chunked
    assert "fce_bwd_kernel" not in src.replace("fce_bwd_tc_kernel",
                                               "").replace(
        "fce_bwd_tf32_kernel", "")
    assert "fce_bwd_tf32_kernel<kVocabRows>" in _function_body(
        src[src.index("namespace tf {"):],
        "template <bool kVocabRows>\nint bwd(")
    assert "return sizeof(T) == 2 && D <= kClusterD;" in src
    bf16_consts = src[src.index("// bf16: tensor cores"):
                      src.index("namespace tc {")]
    consts = dict(re.findall(r"constexpr int (kRanks|kSlice) = (\d+);",
                             bf16_consts))
    assert int(consts["kRanks"]) * int(consts["kSlice"]) == tce._CLUSTER_D
    splits = _function_body(src, 'extern "C" int bigdl_fce_dh_splits(')
    assert "if (dtype == 0) return tf::dh_splits(N, V, D);" in splits
    assert ("return dtype == 1 && clustered<bf16>(D) ? tc::dh_splits(N, V) "
            ": 1;") in splits
    splits = _function_body(src, 'extern "C" int bigdl_fce_fwd_splits(')
    assert ("return dtype == 1 ? tc::fwd_splits(N, V, sms) : "
            "tf::fwd_splits(N, V, sms);") in splits
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in range(1, 2101):
            dp = d + -d % 8
            bwd_route = ("tf32" if code == 0 else "tc_cluster"
                         if dp <= tce._CLUSTER_D else "tc_chunked")
            for kernel in ("dh", "dw"):
                for width in (d, dp):
                    assert (tce.kernel_route(dtype, width, kernel)
                            == bwd_route), (dtype, width, kernel)
            assert tce.kernel_route(dtype, d, "fwd") == (
                "tc" if code == 1 else "tf32")
    assert tce.kernel_route(torch.float16, 1024, "dh") is None
    assert tce.kernel_route(torch.float32, 0, "dh") is None
    assert tce.kernel_route(torch.float32, 1024, "dq") is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_workspace_and_binding_match_the_c_entries(dtype):
    """The workspace the wrapper allocates on each route: on "tf32" (the
    f32 forward, dh and dW/db) the tf32 parts of the walked operand, hi
    then lo, 2 x nX x D floats as ``tf::fwd`` and ``tf::bwd`` split them
    (2·V·D for the forward and dh, 2·N·D for dW), none on the others; and
    the ctypes binding of the C entries (each takes it after the stream),
    parameter for parameter."""
    n, v, d = 100, 3000, 72
    f32 = dtype == torch.float32
    assert tce.workspace_floats("dh", n, v, d, dtype) == (2 * v * d if f32
                                                          else 0)
    assert tce.workspace_floats("dw", n, v, d, dtype) == (2 * n * d if f32
                                                          else 0)
    assert tce.workspace_floats("fwd", n, v, d, dtype) == (2 * v * d if f32
                                                           else 0)
    src = (_CSRC / "fused_ce.cu").read_text()
    tf_src = src[src.index("namespace tf {"):]
    body = _function_body(tf_src, "template <bool kVocabRows>\nint bwd(")
    assert "const int64_t n = static_cast<int64_t>(nX) * D;" in body
    assert "split_pass(X, work, n, st)" in body
    assert "if (!work) return -1;" in body
    body = _function_body(tf_src, "int fwd(")
    assert "const int64_t n = static_cast<int64_t>(V) * D;" in body
    assert "split_pass(w, work, n, st)" in body
    assert "if (!work) return -1;" in body
    assert "tf_split_pass(x, work, work + n, n, sms, st)" in _function_body(
        tf_src, "int split_pass(")

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn
    if not f32:
        _chunked_workspace_matches_the_c_launcher(src)
    fns = tce.bind(Lib())
    for name in ("fwd", "dh", "dw"):
        head = f'extern "C" int bigdl_fce_{name}('
        sig = src[src.index(head) + len(head):]
        params = [p.strip() for p in sig[:sig.index(")")].split(",")]
        assert len(fns[name].argtypes) == len(params), name
        assert params[-2:] == ["void* stream", "float* work"], name


def _chunked_workspace_matches_the_c_launcher(src):
    """``workspace_floats`` on the route "tc_chunked" (bf16 dh and dW/db
    past D 1024) against what ``tc::chunked`` carves out of ``work``: one
    chunk of ``chunk_rows`` resident rows of bf16 dl, each row the walked
    rows rounded up to 8 (V for dh, N for dW), then, for dW, one f32 db
    partial a vocab row and walked tile of ``kFwdCols`` tokens; chunks of
    the most ``kFwdRows``-row tiles whose dl fits ``kChunkBytes`` beside
    the partials, at least one tile, no more than the rows need. The
    constants are read off the source, and the sizes worked out here
    from them at shapes with one chunk, several, a ragged last chunk and
    a row wider than the budget."""
    tc_src = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
    consts = dict(re.findall(r"constexpr int (kFwdRows|kFwdCols) = (\d+);",
                             tc_src))
    rows_, cols = int(consts["kFwdRows"]), int(consts["kFwdCols"])
    budget = int(re.search(r"constexpr int64_t kChunkBytes = (\d+)ll << 20;",
                           tc_src).group(1)) << 20
    assert (rows_, cols, budget) == (tce._TILE_ROWS, tce._TILE_COLS,
                                     tce._CHUNK_BYTES)
    body = _function_body(tc_src, "inline int chunk_rows(")
    assert "const int64_t row = static_cast<int64_t>((nX + 7) / 8 * 8) * 2;" \
        in body
    assert "const int64_t tiles = (kChunkBytes - fixed) / row / kFwdRows;" \
        in body
    assert "return fit < need ? fit : need;" in body
    body = _function_body(tc_src, "template <bool kVocabRows>\nint chunked(")
    for line in (
            "if (!work) return -1;",
            "const int tiles = (nX + kFwdCols - 1) / kFwdCols;",
            "const int64_t parts = kVocabRows ? static_cast<int64_t>(tiles) "
            "* nR : 0;",
            "const int nXp = (nX + 7) / 8 * 8, rc = chunk_rows(nR, nX, 4 * "
            "parts);",
            "bf16* const dl = reinterpret_cast<bf16*>(work);",
            "float* const dbp = work + static_cast<int64_t>(rc) * nXp / 2;"):
        assert line in body, line

    def carved(n_res, n_walk, dw):
        pitch = -(-n_walk // 8) * 8
        parts = -(-n_walk // cols) * n_res if dw else 0
        fit = max(1, (budget - 4 * parts) // (2 * pitch) // rows_) * rows_
        return min(fit, -(-n_res // rows_) * rows_) * pitch // 2 + parts

    for n, v, d in ((8192, 32768, 2048), (3000, 50257, 2056),
                    (1000, 50257, 2056), (24, 40, 1032), (300, 1000, 1032),
                    (7, 70_000_001, 1040)):
        for kernel in ("dh", "dw"):
            dw = kernel == "dw"
            want = carved(v if dw else n, n if dw else v, dw)
            assert tce.workspace_floats(kernel, n, v, d,
                                        torch.bfloat16) == want, (n, v, d)
        assert tce.workspace_floats("fwd", n, v, d, torch.bfloat16) == 0
    # the harness head at D 2048: four chunks of 2048 token rows (dh),
    # five of 7936 vocab rows (dW, beside 4 MiB of db partials): 128 MiB
    assert tce.workspace_floats("dh", 8192, 32768, 2048,
                                torch.bfloat16) * 4 == 128 << 20
    assert tce.workspace_floats("dw", 8192, 32768, 2048,
                                torch.bfloat16) * 4 == 128 << 20

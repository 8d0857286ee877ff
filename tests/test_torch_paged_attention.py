"""The port's paged attention (bigdl_tpu_torch.ops.paged_attention)
against the JAX package's Pallas kernel, run as its own tests run it on
the CPU (interpret mode).

On the CPU the port's wrapper takes its plain version
(``paged_attention_ref``: the ``_paged_view`` gather + ``_attend_grouped``),
so these tests hold that plain version — the yardstick the CUDA kernel is
compared with on the card by ``chip_smoke.py`` — to the JAX kernel. The
split-KV decode kernel's own plain version (``paged_attention_split_ref``:
per-split partials and their merge) is held to the JAX kernel the same
way, over split widths and rows that end on, before and after a split
boundary.

The tensor-core prefill kernel's arithmetic in its order
(``paged_attention_tile_ref``: an online softmax over key tiles, p
rounded to the pool dtype at the running max) is held to the JAX kernel
at tiles of one page, where both walk the same tiles, and to the plain
version at the kernel's 64-key tiles; the row-tile kernel's
(``paged_attention_row_ref``: 8-key groups a page, whatever chunk of the
page the kernel stages) to the JAX kernel at the plain version's
tolerances; the route mirror (``kernel_route``) is pinned for the serving
geometry and for each geometry that goes to the row-tile kernel.

Tolerances: f32 pools 2e-5 (the JAX tests' own: same math, sums in
another order). bf16 pools 1e-2 absolute: both sides round the softmax
weights p to bf16 before P·V (relative error 2^-9), but at different
points — the Pallas kernel rounds unnormalised per-page weights, the
plain version normalised ones — so outputs, weighted means of N(0, 1)
values, differ by up to about 2^-9 · max|v|. The tile version at tiles
of one page against the JAX kernel: 2e-5 in both dtypes, since both
round the same unnormalised weights at the same running max and differ
only in the order of f32 sums (a weight whose f32 value lies within that
difference of a bf16 rounding boundary, about one in 2^16, would round
the other way; none does at these seeds).
"""
import functools
import inspect
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigdl_tpu.ops.pallas import paged_attention as jpa
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.models.transformer import serving as tsv
from bigdl_tpu_torch.ops import paged_attention as tpa

_DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 2e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2, 0.0)}


def _geometry(b, t, h, kv, d, n_pages, s, p, seed=0):
    rs = np.random.default_rng(seed)
    q = rs.standard_normal((b, t, h, d), np.float32)
    kp = rs.standard_normal((n_pages, s, kv, d), np.float32)
    vp = rs.standard_normal((n_pages, s, kv, d), np.float32)
    table = rs.permutation(n_pages)[:b * p].reshape(b, p).astype(np.int32)
    return q, kp, vp, table


def _compare(q, kp, vp, table, q_start, dtype, scale=None,
             fn=tpa.paged_attention):
    jdt, tdt, atol, rtol = _DTYPES[dtype]
    q_start = np.asarray(q_start, np.int32)
    want = jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(q_start), scale=scale,
        interpret=True)
    got = fn(
        torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.from_numpy(q_start), scale=scale)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
class TestRefParity:

    @pytest.mark.parametrize("h,kv", [(8, 2), (4, 1), (4, 4)],
                             ids=["gqa", "mqa", "mha"])
    def test_grouping_modes(self, h, kv, dtype):
        q, kp, vp, table = _geometry(3, 1, h, kv, 32, 32, 8, 4)
        # mid-page, last slot of page 1, single-page row
        _compare(q, kp, vp, table, [5, 15, 2], dtype, scale=32 ** -0.5)

    def test_multi_column_causal(self, dtype):
        q, kp, vp, table = _geometry(2, 4, 4, 2, 16, 16, 4, 6, seed=1)
        _compare(q, kp, vp, table, [0, 9], dtype)

    @pytest.mark.parametrize("pos", [0, 7, 8, 31],
                             ids=["first-token", "page-end", "page-start",
                                  "last-slot"])
    def test_page_boundary_positions(self, pos, dtype):
        q, kp, vp, table = _geometry(1, 1, 4, 1, 16, 8, 8, 4, seed=2)
        _compare(q, kp, vp, table, [pos], dtype)

    @pytest.mark.parametrize("m,q_start", [(24, [2, 11, 0]),
                                           (13, [12, 4, 0])],
                             ids=["paged-24", "prime-13"])
    def test_dense_cache_view(self, m, q_start, dtype):
        jdt, tdt, atol, rtol = _DTYPES[dtype]
        rs = np.random.default_rng(3)
        q = rs.standard_normal((3, 3, 4, 16), np.float32)
        ck = rs.standard_normal((3, m, 2, 16), np.float32)
        cv = rs.standard_normal((3, m, 2, 16), np.float32)
        qs = np.asarray(q_start, np.int32)
        want = jpa.dense_cache_attention(
            jnp.asarray(q), jnp.asarray(ck, jdt), jnp.asarray(cv, jdt),
            jnp.asarray(qs), interpret=True)
        got = tpa.dense_cache_attention(
            torch.from_numpy(q), torch.from_numpy(ck).to(tdt),
            torch.from_numpy(cv).to(tdt), torch.from_numpy(qs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=atol, rtol=rtol)


# (B, T, H, KV, D, page size, table entries, q_start of each row): head
# dim 192 (three 64-wide chunks; 24 bf16 / 48 f32 16-byte vectors a row,
# which do not divide the split kernel's 128 threads) and pages of 256
# slots (the row-tile kernel streams them in chunks: f32 pools, G 3),
# each for a decode call (T·G <= 16: the split route) and a prefill
# call; head dims 320 and 512, which every call runs on the row-tile
# kernel; pages of 300 slots (S % 8 != 0: the row-tile kernel's last
# 8-key group of a page is short)
_WIDE_CASES = {
    "d192-decode": (3, 1, 4, 2, 192, 16, 6, [0, 37, 95]),
    "d192-prefill": (2, 40, 4, 2, 192, 16, 6, [0, 50]),
    "s256-decode": (2, 1, 8, 2, 128, 256, 3, [100, 700]),
    "s256-prefill": (2, 70, 8, 2, 128, 256, 3, [0, 300]),
    "d320-decode": (3, 1, 4, 2, 320, 16, 6, [0, 37, 95]),
    "d320-prefill": (2, 40, 4, 2, 320, 16, 6, [0, 50]),
    "d512-decode": (3, 1, 4, 2, 512, 16, 6, [0, 37, 95]),
    "d512-prefill": (2, 40, 4, 2, 512, 16, 6, [0, 50]),
    "s256-g3-prefill": (2, 40, 6, 2, 64, 256, 3, [0, 300]),
    "s300-prefill": (2, 40, 8, 2, 64, 300, 3, [0, 500]),
    # Qwen2.5's G 7 (14 heads over 2 kv heads, as the 0.5B model): decode
    # (T·G 14, the split route) and prefill over pages of 12 and of 300
    # slots and the dense view's 125 (the tensor-core route, its padded
    # walk); G 5 over pages of 7
    "g7-decode": (2, 2, 14, 2, 32, 16, 4, [5, 40]),
    "g7-s12-prefill": (2, 20, 14, 2, 32, 12, 6, [0, 30]),
    "g7-s300-prefill": (2, 12, 14, 2, 32, 300, 2, [0, 400]),
    "g7-s125-prefill": (1, 24, 14, 2, 32, 125, 3, [200]),
    "g5-s7-prefill": (2, 9, 10, 2, 32, 7, 6, [0, 20]),
    # head dim 576, past the head dims the JAX tests reach (the row-tile
    # kernel takes D at run time past 256)
    "d576-decode": (3, 1, 2, 1, 576, 16, 4, [0, 17, 50]),
    "d576-prefill": (2, 3, 2, 1, 576, 16, 3, [0, 20]),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_WIDE_CASES))
def test_wide_heads_and_large_pages_match_jax(case, dtype):
    """Paged attention at head dims 192, 320, 512 and 576, at pages of 7,
    12, 125, 256 and 300 slots and at G 3, 5 and 7 against the JAX
    kernel in interpret mode, at the file's tolerances: the plain
    version, and the plain versions of the
    kernels a call of its shape runs on the card
    (``paged_attention_split_ref`` at one and at two pages a split for a
    decode call, ``paged_attention_tile_ref`` at the tensor-core kernel's
    64-key tiles of its padded walk for a prefill call, and
    ``paged_attention_row_ref`` where the call's route is the row-tile
    kernel)."""
    b, t, h, kv, d, s, p, starts = _WIDE_CASES[case]
    q, kp, vp, table = _geometry(b, t, h, kv, d, b * p + 1, s, p, seed=31)
    _compare(q, kp, vp, table, starts, dtype)
    if t * (h // kv) <= tpa._SPLIT_ROWS:
        for pps in (1, 2):
            _compare(q, kp, vp, table, starts, dtype, fn=functools.partial(
                tpa.paged_attention_split_ref, pages_per_split=pps))
    else:
        _compare(q, kp, vp, table, starts, dtype, fn=functools.partial(
            tpa.paged_attention_tile_ref, key_tile=64))
    if tpa.kernel_route(t, h, kv, d, s, p, _DTYPES[dtype][1]) == "row":
        _compare(q, kp, vp, table, starts, dtype,
                 fn=tpa.paged_attention_row_ref)


# (B, T, H, KV, D, page size, table entries, q_start of each row, pool
# dtype): head dims past the row-tile kernel's wide form (1152 f32, 1792
# bf16), which run its column-sliced form (4 and 3 slices of 512
# columns, the last one narrower): decode and prefill, pages of 8 and of
# 12 (S % 8 != 0: a short last key group a page), G 2 and 3
_PAST_CAP_CASES = {
    "d1856-bf16-decode": (2, 1, 4, 2, 1856, 8, 3, [0, 17], "bf16"),
    "d1856-bf16-prefill": (2, 5, 6, 2, 1856, 12, 3, [0, 20], "bf16"),
    "d1216-f32-decode": (2, 1, 4, 2, 1216, 8, 3, [3, 20], "f32"),
    "d1216-f32-prefill": (2, 5, 6, 2, 1216, 12, 3, [0, 25], "f32"),
}


@pytest.mark.parametrize("case", sorted(_PAST_CAP_CASES))
def test_past_the_wide_cap_matches_jax(case):
    """Head dims past the wide form's cap (bf16 D 1856, f32 D 1216), which
    the JAX kernel takes as it takes every multiple of 64: the route is
    the sliced row-tile kernel's for f32 pools and the sliced tensor-core
    kernel's for bf16 ones, and the plain version, the row-tile kernel's
    arithmetic in its order (``paged_attention_row_ref``, which the
    sliced form keeps) and, for bf16, the sliced tensor-core kernel's
    (``_sliced_tc``) match the JAX kernel in interpret mode at the file's
    tolerances."""
    b, t, h, kv, d, s, p, starts, dtype = _PAST_CAP_CASES[case]
    tdt = _DTYPES[dtype][1]
    assert tpa.kernel_route(t, h, kv, d, s, p, tdt) == (
        "tc_sliced" if dtype == "bf16" else "row_sliced")
    assert tpa.paged_kernel_supported(d, s, tdt, h, kv)
    q, kp, vp, table = _geometry(b, t, h, kv, d, b * p + 1, s, p, seed=47)
    _compare(q, kp, vp, table, starts, dtype)
    _compare(q, kp, vp, table, starts, dtype,
             fn=tpa.paged_attention_row_ref)
    if dtype == "bf16":
        _compare(q, kp, vp, table, starts, dtype,
                 fn=functools.partial(_sliced_tc, own=4))


def _sliced_tc(q, kp, vp, table, q_start, own, scale=None):
    """The sliced tensor-core prefill's arithmetic (route "tc_sliced"),
    on the CPU: q, K and V zero-padded to the built head dim D
    (``ops.padded_head_dim``), every score summed over D in 64-column
    chunks in order, then the output cut into slices of ``own`` chunks,
    each running its own online softmax over the kernel's 64-key tiles of
    the padded slot space (``paged_attention_tile_ref``'s spans), p
    rounded to the pool dtype at the running max, and P·V over its own
    columns alone, a key at a time. Each slice forms its scores afresh,
    as each CTA does."""
    b, t, h, d = q.shape
    kv = kp.shape[2]
    g = h // kv
    dd = ops.padded_head_dim(d)
    nc = dd // 64
    scale = d ** -0.5 if scale is None else scale

    def pad(x):
        return torch.nn.functional.pad(x.float(), (0, dd - d))
    qg = pad(q.to(kp.dtype)).reshape(b, t, kv, g, dd)
    ck, cv = (pad(tpa._paged_view(x, table)) for x in (kp, vp))
    n = ck.shape[1]
    upto = q_start.long()[:, None] + torch.arange(t)[None, :]
    s_ = kp.shape[1]
    s8 = -(-s_ // tpa._SLOT_PAD) * tpa._SLOT_PAD
    n_pad = table.shape[1] * s8

    def logical(k):
        return k // s8 * s_ + min(k % s8, s_)
    spans = [(logical(k0), logical(min(k0 + 64, n_pad)))
             for k0 in range(0, n_pad, 64)]
    slices = []
    for c0 in range(0, nc, own):
        sc = torch.zeros((b, kv, g, t, n))
        for c in range(nc):
            cols = slice(64 * c, 64 * c + 64)
            sc = sc + torch.einsum("btkgd,bmkd->bkgtm", qg[..., cols],
                                   ck[..., cols])
        sc = sc * scale
        sc = torch.where(torch.arange(n) > upto[:, None, None, :, None],
                         tpa._NEG, sc)
        cols = slice(64 * c0, 64 * min(c0 + own, nc))
        v = cv[..., cols]
        m = torch.full(sc.shape[:-1], -torch.inf)
        l_ = torch.zeros_like(m)
        acc = torch.zeros(sc.shape[:-1] + (v.shape[-1],))
        for k0, k1 in spans:
            if k0 == k1:
                continue
            st = sc[..., k0:k1]
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(st - m_new[..., None]).to(kp.dtype).float()
            l_ = l_ * corr + torch.exp(st - m_new[..., None]).sum(-1)
            pv = torch.zeros_like(acc)
            for k in range(k1 - k0):
                pv = pv + p[..., k, None] * v[:, k0 + k, :, None, None, :]
            acc = acc * corr[..., None] + pv
            m = m_new
        slices.append(acc / l_[..., None])
    o = torch.cat(slices, -1)[..., :d]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


# (B, T, H, KV, D, page size, table entries, q_start of each row): bf16
# calls past head dim 256, which take the sliced tensor-core kernel: D
# 320 (slices of 3 + 2 chunks), 512 (4 + 4) and 1856 (29 chunks: 4 x 7
# + 1, the built 1856 a multiple of 64), G 2 and 7 (padded to 8 in the
# kernel's fold), pages of 12 (padded to 16 slots) and 16, rows starting
# past 0, prefill and a decode step
_SLICED_TC_CASES = {
    "d320-g7-s16": (2, 4, 14, 2, 320, 16, 5, [3, 40]),
    "d512-g2-s12": (2, 12, 4, 2, 512, 12, 6, [5, 40]),
    "d512-g7-s16": (2, 3, 14, 2, 512, 16, 4, [0, 33]),
    "d1856-g2-s12": (2, 9, 4, 2, 1856, 12, 5, [7, 30]),
    "d512-g2-decode": (3, 1, 4, 2, 512, 16, 4, [0, 17, 50]),
}


@pytest.mark.parametrize("case", sorted(_SLICED_TC_CASES))
def test_sliced_tc_arithmetic_matches_jax(case):
    """The sliced tensor-core prefill's arithmetic (``_sliced_tc``: scores
    over 64-column chunks in order, a per-slice online softmax at 64-key
    tiles, p rounded to bf16) against the JAX kernel in interpret mode at
    the file's bf16 tolerance, and against the kernel's own order without
    slices (``paged_attention_tile_ref`` at 64-key tiles, 2e-5: the same
    tiles and roundings, f32 sums in another order); every slicing (1, 2,
    3, 4 chunks a slice, and one slice of all of D) gives the same bits,
    since every slice forms the same scores, running max and sum."""
    b, t, h, kv, d, s, p, starts = _SLICED_TC_CASES[case]
    assert tpa.kernel_route(t, h, kv, d, s, p, torch.bfloat16) == "tc_sliced"
    q, kp, vp, table = _geometry(b, t, h, kv, d, b * p + 1, s, p, seed=d + h)
    fn = functools.partial(_sliced_tc, own=4)
    _compare(q, kp, vp, table, starts, "bf16", fn=fn)
    args = (torch.from_numpy(q), torch.from_numpy(kp).to(torch.bfloat16),
            torch.from_numpy(vp).to(torch.bfloat16), torch.from_numpy(table),
            torch.tensor(starts, dtype=torch.int32))
    got = _sliced_tc(*args, own=4)
    np.testing.assert_allclose(
        got.numpy(), tpa.paged_attention_tile_ref(*args, key_tile=64).numpy(),
        atol=2e-5, rtol=2e-5)
    nc = ops.padded_head_dim(d) // 64
    for own in (1, 2, 3, nc):
        assert torch.equal(_sliced_tc(*args, own=own), got), own


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,q_start", [(8, [0, 37]), (12, [5, 50]),
                                       (7, [0, 30])],
                         ids=["s8", "s12", "s7"])
def test_row_ref_matches_jax(s, q_start, dtype):
    """The row-tile kernel's arithmetic in its order
    (``paged_attention_row_ref``: 8-key groups from each multiple of 8
    of a page, the last one short where S % 8 != 0) against the JAX
    kernel in interpret mode at the file's tolerances (the JAX kernel
    rounds p at its own running maxima, a page a tile, as the plain
    version does at another point), G 3 over pages of 8, 12 and 7."""
    q, kp, vp, table = _geometry(2, 20, 6, 2, 32, 2 * 8 + 1, s, 8,
                                 seed=40 + s)
    _compare(q, kp, vp, table, q_start, dtype,
             fn=tpa.paged_attention_row_ref)


@pytest.mark.parametrize("s", [8, 16, 24])
def test_row_ref_at_whole_groups_is_the_tile_ref_at_8(s):
    """Where S % 8 == 0 the row-tile kernel's 8-key groups a page are
    the 8-key tiles of the whole view: the two plain versions walk the
    same spans, bit for bit (bf16 pools, G 4)."""
    q, kp, vp, table = _geometry(2, 17, 8, 2, 32, 2 * 6 + 1, s, 6,
                                 seed=50 + s)
    args = (torch.from_numpy(q), torch.from_numpy(kp).to(torch.bfloat16),
            torch.from_numpy(vp).to(torch.bfloat16), torch.from_numpy(table),
            torch.tensor([0, 41], dtype=torch.int32))
    assert torch.equal(tpa.paged_attention_row_ref(*args),
                       tpa.paged_attention_tile_ref(*args, key_tile=8))


def _edge_starts(width, n_keys):
    """Decode rows (T = 1, last key = q_start) at 0 (a free batcher slot
    decoding into its scratch page), ending one key before, on and one
    key after the first split boundary past 0 (the key on the boundary is
    the first of its split), and at the table's last slot."""
    k = width if width < n_keys else 0
    return sorted({0, max(k - 1, 0), k, min(k + 1, n_keys - 1),
                   n_keys - 1})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pps", [1, 2, 3, "P"])
class TestSplitRefParity:
    """``paged_attention_split_ref`` (the split-KV decode kernel's plain
    version) against the JAX kernel in interpret mode, at the file's
    tolerances; short rows leave whole splits past their last key."""

    _P, _S = 6, 8

    def _pps(self, pps):
        return self._P if pps == "P" else pps

    @pytest.mark.parametrize("h,kv", [(8, 2), (4, 1), (4, 4)],
                             ids=["gqa", "mqa", "mha"])
    def test_split_edges(self, h, kv, pps, dtype):
        pps = self._pps(pps)
        starts = _edge_starts(pps * self._S, self._P * self._S)
        q, kp, vp, table = _geometry(len(starts), 1, h, kv, 32,
                                     len(starts) * self._P + 1, self._S,
                                     self._P, seed=7)
        _compare(q, kp, vp, table, starts, dtype, fn=functools.partial(
            tpa.paged_attention_split_ref, pages_per_split=pps))

    def test_multi_column(self, pps, dtype):
        """T = 2 columns of G = 2 heads (T·G = 4 rows: the split kernel's
        tile): the first column's last key lies one before the tile's."""
        pps = self._pps(pps)
        width = pps * self._S
        starts = [0, width - 2 if width > 1 else 0, width - 1, 30]
        q, kp, vp, table = _geometry(4, 2, 4, 2, 16, 4 * self._P + 1,
                                     self._S, self._P, seed=8)
        _compare(q, kp, vp, table, starts, dtype, fn=functools.partial(
            tpa.paged_attention_split_ref, pages_per_split=pps))


@pytest.mark.parametrize("pps", [1, 3, 8, 129])
def test_split_ref_matches_plain_at_serving_heads(pps):
    """The two plain versions agree in f32 at the serving heads (H 8, KV
    2, D 128, pages of 16, the batcher's 129-entry tables) over rows of
    1..2048 keys (sum order alone: 2e-5)."""
    lens = [1, 16, 17, 127, 128, 129, 1100, 2048]
    q, kp, vp, table = _geometry(8, 1, 8, 2, 128, 8 * 129 + 1, 16, 129,
                                 seed=9)
    args = (torch.from_numpy(q), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(table),
            torch.tensor([n - 1 for n in lens], dtype=torch.int32))
    want = tpa.paged_attention_ref(*args)
    got = tpa.paged_attention_split_ref(*args, pages_per_split=pps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_decode_split_pages_is_a_function_of_host_integers():
    """The split width comes from (B, KV, P, SMs) alone — never from the
    lengths, which live on the card: splits enough for two CTAs an SM
    were every table full, at least a page each."""
    assert list(inspect.signature(tpa.decode_split_pages).parameters) \
        == ["b", "kv", "p", "sms"]
    # the serving decode: 8 rows x 2 kv heads, 129-page tables, 132 SMs
    assert tpa.decode_split_pages(8, 2, 129, 132) == 8
    assert -(-129 // 8) == 17
    assert tpa.decode_split_pages(8, 2, 16, 132) == 1     # dense view
    assert tpa.decode_split_pages(1, 2, 129, 132) == 1
    assert tpa.decode_split_pages(64, 8, 129, 132) == 129  # one split
    assert tpa.decode_split_pages(8, 2, 1, 132) == 1
    # a split's page ids are staged in shared memory: at most 4096
    assert tpa.decode_split_pages(600, 8, 10000, 132) == 3334
    for b, kv, p, sms in [(1, 1, 1, 1), (3, 2, 50, 7), (8, 2, 129, 132),
                          (2, 8, 4096, 132), (128, 1, 33, 132),
                          (600, 8, 10000, 132)]:
        pps = tpa.decode_split_pages(b, kv, p, sms)
        n_split = -(-p // pps)
        assert 1 <= pps <= min(p, 4096)
        assert (n_split - 1) * pps < p                   # none empty
        assert n_split <= max(1, -(-2 * sms // (b * kv)), -(-p // 4096))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("q_start", [[0, 0], [5, 13]], ids=["qs0", "qs>0"])
@pytest.mark.parametrize("g,t", [(1, 23), (2, 11), (4, 9)],
                         ids=["g1", "g2", "g4"])
def test_tile_ref_at_page_tiles_matches_jax(g, t, q_start, dtype):
    """At tiles of one page the tile version walks the JAX kernel's own
    tiles: same running max, same rounding points (2e-5, module
    docstring). T·G (23, 22, 36) is no multiple of 64; pages of 8, a
    6-entry table, rows starting at 0 and past it."""
    q, kp, vp, table = _geometry(2, t, 2 * g, 2, 16, 24, 8, 6, seed=10 + g)
    _, tdt, _, _ = _DTYPES[dtype]
    qs = np.asarray(q_start, np.int32)
    want = jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp, _DTYPES[dtype][0]),
        jnp.asarray(vp, _DTYPES[dtype][0]), jnp.asarray(table),
        jnp.asarray(qs), interpret=True)
    got = tpa.paged_attention_tile_ref(
        torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
        torch.from_numpy(qs), key_tile=8)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,p,q_start", [(8, 20, [0, 37, 100]),
                                         (16, 9, [3, 64, 127]),
                                         (24, 7, [0, 50, 160])],
                         ids=["s8", "s16", "s24"])
def test_tile_ref_at_kernel_tiles_matches_plain(s, p, q_start, dtype):
    """At the kernel's 64-key tiles (several a row, the last one cut by
    the table's end where P·S is no multiple of 64) the tile version is
    the plain version's function, at the file's tolerances."""
    jdt, tdt, atol, rtol = _DTYPES[dtype]
    q, kp, vp, table = _geometry(3, 33, 8, 2, 32, 3 * p + 2, s, p,
                                 seed=20 + s)
    args = (torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
            torch.tensor(q_start, dtype=torch.int32))
    got = tpa.paged_attention_tile_ref(*args, key_tile=64)
    want = tpa.paged_attention_ref(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("s,p,q_start", [(7, 40, [0, 150, 270]),
                                         (12, 24, [3, 100, 250]),
                                         (125, 3, [0, 200, 330]),
                                         (300, 2, [0, 290, 560])],
                         ids=["s7", "s12", "s125", "s300"])
def test_padded_tile_ref_matches_plain(s, p, q_start):
    """The tensor-core kernel's walk over pages padded to a multiple of 8
    slots (``paged_attention_tile_ref``'s default: each 64-key tile of
    the padded slot space takes the logical keys among its slots, so the
    spans are uneven) is the plain version's function in f32, within sum
    order (2e-5): pages of 7, 12, 125 and 300 slots, G 7 (14 heads over
    2 kv heads), rows starting at 0 and deep in their tables."""
    q, kp, vp, table = _geometry(3, 33, 14, 2, 32, 3 * p + 1, s, p,
                                 seed=60 + s)
    args = (torch.from_numpy(q), torch.from_numpy(kp),
            torch.from_numpy(vp), torch.from_numpy(table),
            torch.tensor(q_start, dtype=torch.int32))
    got = tpa.paged_attention_tile_ref(*args, key_tile=64)
    np.testing.assert_allclose(got.numpy(),
                               tpa.paged_attention_ref(*args).numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [8, 16, 24, 256])
def test_padded_tile_ref_at_whole_groups_is_unpadded(s):
    """Where S % 8 == 0 no slot is padded (bf16 pools, G 4): tiles of one
    page are the JAX kernel's own tiles, the same running max and
    rounding points (2e-5 of the JAX kernel in interpret mode), and the
    kernel's 64-key tiles hold the JAX kernel's function at the file's
    bf16 tolerance."""
    q, kp, vp, table = _geometry(2, 40, 8, 2, 32, 2 * 5 + 1, s, 5,
                                 seed=70 + s)
    jdt, tdt, atol, rtol = _DTYPES["bf16"]
    qs = np.asarray([0, 37], np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
            torch.from_numpy(qs))
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(qs), interpret=True))
    np.testing.assert_allclose(
        tpa.paged_attention_tile_ref(*args, key_tile=s).numpy(), want,
        atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        tpa.paged_attention_tile_ref(*args, key_tile=64).numpy(), want,
        atol=atol, rtol=rtol)


_BF16, _F32 = torch.bfloat16, torch.float32

# (t, h, kv, d, s, p, dtype) -> the kernel the C entry runs
_ROUTE_CASES = {
    # the serving path: prefill of a 512-token bucket, decode, the
    # dense-cache view of a 2048-token cache (pages of 128)
    "serve-prefill": ((512, 8, 2, 128, 16, 129, _BF16), "tc"),
    "serve-prefill-t32": ((32, 8, 2, 128, 16, 129, _BF16), "tc"),
    "serve-decode": ((1, 8, 2, 128, 16, 129, _BF16), "split"),
    "decode-16-rows": ((2, 16, 2, 128, 16, 10, _BF16), "split"),
    "17-rows": ((17, 2, 2, 128, 16, 10, _BF16), "tc"),
    "dense-view": ((64, 8, 2, 128, 128, 16, _BF16), "tc"),
    "d32": ((64, 4, 1, 32, 16, 9, _BF16), "tc"),
    "d64": ((64, 8, 2, 64, 16, 9, _BF16), "tc"),
    "d256": ((64, 4, 2, 256, 16, 9, _BF16), "tc"),
    "d192": ((64, 4, 2, 192, 16, 9, _BF16), "tc"),
    "d192-decode": ((1, 4, 2, 192, 16, 9, _BF16), "split"),
    "s256": ((512, 8, 2, 128, 256, 9, _BF16), "tc"),
    "s256-decode": ((1, 8, 2, 128, 256, 9, _BF16), "split"),
    "mha": ((64, 8, 8, 128, 16, 9, _BF16), "tc"),
    "g8": ((64, 8, 1, 128, 16, 9, _BF16), "tc"),
    "s8": ((64, 8, 2, 128, 8, 9, _BF16), "tc"),
    "s32": ((64, 8, 2, 128, 32, 9, _BF16), "tc"),
    "4096-pages": ((64, 8, 2, 128, 16, 4096, _BF16), "tc"),
    # every bf16 prefill at D <= 256 takes the tensor cores at any page
    # size (pages padded to a multiple of 8 slots) and any G up to 64
    # (padded to a power of two): pages of 7, 12, 125 (the dense view of
    # a 1000-slot cache) and 300, G 3, and Qwen2.5's G 7 (0.5B, 7B), 6
    # (1.5B) and 5 (14B, 32B)
    "s7": ((64, 8, 2, 64, 7, 30, _BF16), "tc"),
    "s12": ((64, 8, 2, 64, 12, 30, _BF16), "tc"),
    "s125": ((64, 8, 2, 128, 125, 8, _BF16), "tc"),
    "s300": ((300, 8, 2, 128, 300, 8, _BF16), "tc"),
    "g3": ((64, 6, 2, 64, 16, 9, _BF16), "tc"),
    "g5": ((512, 40, 8, 128, 16, 129, _BF16), "tc"),
    "g6": ((512, 12, 2, 128, 16, 129, _BF16), "tc"),
    "g7": ((512, 28, 4, 128, 16, 129, _BF16), "tc"),
    "g7-s300": ((64, 14, 2, 64, 300, 4, _BF16), "tc"),
    "g64": ((17, 64, 1, 64, 16, 9, _BF16), "tc"),
    # past G 64 the fold is G itself, on the tensor cores too, decode
    # (T·G past 16) as well: Falcon-7B's 71 heads over one kv head, G 128
    # decode, G 96 over 2 kv heads
    "g71": ((64, 71, 1, 64, 16, 9, _BF16), "tc"),
    "g71-decode": ((1, 71, 1, 64, 16, 9, _BF16), "tc"),
    "g128": ((1, 128, 1, 64, 16, 9, _BF16), "tc"),
    "g96-kv2": ((64, 192, 2, 64, 16, 9, _BF16), "tc"),
    # decode at G 7 stays on the split-KV kernel (T·G 7 <= 16)
    "g7-decode": ((1, 28, 4, 128, 16, 129, _BF16), "split"),
    # the row-tile kernel: f32 pools, a table too long to stage (at any
    # G), head dims past 256
    "f32": ((512, 8, 2, 128, 16, 129, _F32), "row"),
    "s256-f32": ((512, 8, 2, 128, 256, 9, _F32), "row"),
    "g7-f32": ((512, 28, 4, 128, 16, 129, _F32), "row"),
    "g71-f32": ((64, 71, 1, 64, 16, 9, _F32), "row"),
    "4097-pages": ((64, 8, 2, 128, 16, 4097, _BF16), "row"),
    "g71-4097-pages": ((64, 71, 1, 64, 16, 4097, _BF16), "row"),
    # past head dim 256 a bf16 call, decode too, runs the tensor-core
    # prefill with its output's columns sliced, at any head dim whose
    # rows are 16-byte multiples (1864 padded to 1920, 304 to 320), any
    # page size (300), G up to 64 and tables up to 4096 entries; f32 and
    # the rest stay on the row-tile kernel
    "d320-decode": ((1, 8, 2, 320, 16, 9, _BF16), "tc_sliced"),
    "d320-prefill": ((64, 8, 2, 320, 16, 9, _BF16), "tc_sliced"),
    "d512-decode": ((1, 8, 2, 512, 16, 9, _F32), "row"),
    "d512-prefill": ((64, 8, 2, 512, 16, 9, _BF16), "tc_sliced"),
    "d576-decode": ((1, 2, 1, 576, 16, 9, _BF16), "tc_sliced"),
    "d576-prefill": ((64, 8, 2, 576, 16, 9, _F32), "row"),
    "d1024-decode": ((1, 8, 2, 1024, 16, 9, _F32), "row"),
    "d1024-prefill": ((64, 8, 2, 1024, 16, 9, _BF16), "tc_sliced"),
    "d304-prefill": ((64, 8, 2, 304, 16, 9, _BF16), "tc_sliced"),
    "d1864-prefill": ((96, 4, 2, 1864, 16, 20, _BF16), "tc_sliced"),
    "d512-s300": ((64, 8, 2, 512, 300, 9, _BF16), "tc_sliced"),
    "d512-g7-s12": ((40, 14, 2, 512, 12, 30, _BF16), "tc_sliced"),
    "d320-g64": ((17, 64, 1, 320, 16, 4, _BF16), "tc_sliced"),
    "d512-17-rows": ((17, 1, 1, 512, 16, 9, _BF16), "tc_sliced"),
    "d512-4096-pages": ((64, 8, 2, 512, 16, 4096, _BF16), "tc_sliced"),
    "d512-16-rows": ((8, 4, 2, 512, 16, 9, _BF16), "tc_sliced"),
    "d512-decode-bf16": ((1, 8, 2, 512, 16, 9, _BF16), "tc_sliced"),
    "d512-g71-decode": ((1, 71, 1, 512, 16, 9, _BF16), "row"),
    "d2048-g65-decode": ((1, 65, 1, 2048, 16, 9, _BF16), "row_sliced"),
    "d512-f32-prefill": ((64, 8, 2, 512, 16, 9, _F32), "row"),
    "d512-g71": ((64, 71, 1, 512, 16, 9, _BF16), "row"),
    "d512-g65-kv2": ((64, 130, 2, 512, 16, 9, _BF16), "row"),
    "d512-4097-pages": ((64, 8, 2, 512, 16, 4097, _BF16), "row"),
    "d300-prefill": ((64, 8, 2, 300, 16, 9, _BF16), "row"),
    "d1860-prefill": ((96, 4, 2, 1860, 16, 20, _BF16), "row_sliced"),
    "d2048-4097-pages": ((64, 8, 2, 2048, 16, 4097, _BF16), "row_sliced"),
    # past the wide form's cap (1152 f32, 1792 bf16) its column-sliced
    # form; at the cap the wide form
    "d1152-f32": ((64, 8, 2, 1152, 16, 9, _F32), "row"),
    "d1216-f32": ((64, 8, 2, 1216, 16, 9, _F32), "row_sliced"),
    "d1216-f32-decode": ((1, 8, 2, 1216, 16, 9, _F32), "row_sliced"),
    "d1792": ((64, 8, 2, 1792, 16, 9, _BF16), "tc_sliced"),
    "d1792-decode": ((1, 8, 2, 1792, 16, 9, _BF16), "tc_sliced"),
    "d1856": ((64, 8, 2, 1856, 16, 9, _BF16), "tc_sliced"),
    "d1856-decode": ((1, 8, 2, 1856, 16, 9, _BF16), "tc_sliced"),
    "d2048": ((64, 8, 2, 2048, 300, 9, _BF16), "tc_sliced"),
    "d4096": ((1, 8, 2, 4096, 16, 9, _BF16), "tc_sliced"),
    "d4096-f32": ((64, 8, 2, 4096, 16, 9, _F32), "row_sliced"),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_kernel_route(case):
    args, route = _ROUTE_CASES[case]
    assert tpa.kernel_route(*args) == route


def test_route_constants_match_the_c_entry():
    """The mirror's limits are the C entry's: split rows, the tensor-core
    CTA's folded rows (the most G it pads) and its staged table entries,
    the head dim past which only the row-tile kernel is built, and
    route_of's tests of head dim (first), rows (T·G), dtype and table
    width, none of G alone or of page size up to head dim 256, and past
    it the sliced tensor-core kernel's (``takes_tc_sliced``: bf16, rows
    of a 16-byte multiple, G up to the boxed fold's 64, tables it
    stages, decode too; its slices of at most 4 chunks, as
    even as they come, ``sl_own``); the tensor-core kernel's fold
    and padding (G to a power of two up to kWgRows, G itself past it;
    pages to a multiple of kSlotPad slots, boxes of the largest of
    64/32/16/8 rows dividing the padded page); and the row-tile kernel's
    chunk plan
    (``row_chunk_slots``: its key group, shared memory, the wide kernel's
    fixed part past head dim 256 and its cap)."""
    src = (Path(tpa.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    def body(head):
        part = src[src.index(head):]
        return part[:part.index("\n}\n")]
    assert const("kSplitRows") == tpa._SPLIT_ROWS
    assert const("kWgRows") == tpa._TC_ROWS
    assert const("kTcMaxPages") == tpa._TC_MAX_PAGES
    assert const("kRowOnlyPast") == tpa._ROW_ONLY_PAST
    assert const("kKeyChunk") == tpa._KEY_CHUNK
    assert const("kSmemMax") == tpa._SMEM_LIMIT
    assert const("kSlotPad") == tpa._SLOT_PAD
    assert const("kWarps") * const("kWideRpw") == tpa._WIDE_ROWS
    route_of = body("Route route_of(")
    assert ("if (dtype == 1 && P <= tc::kTcMaxPages) return kRouteTc;"
            in route_of)
    after_split = route_of.split("kRouteSplit;")[1]
    assert "S" not in after_split and "G" not in after_split
    # by the built head dim first, then rows of no 16-byte multiple
    assert "D = built_dim(Dt), elt = dtype == 0 ? 4 : 2;" in route_of
    assert route_of.index("if (D > kRowOnlyPast)") \
        < route_of.index("takes_tc_sliced(dtype, G, Dt, P)") \
        < route_of.index("if (Dt * elt % 16 != 0) return kRouteRow;") \
        < route_of.index("kSplitRows")
    assert ("if (takes_tc_sliced(dtype, G, Dt, P)) return kRouteTcSliced;"
            in route_of)
    takes = " ".join(body("bool takes_tc_sliced(").split())
    assert ("return dtype == 1 && Dt * 2 % 16 == 0 && P <= tc::kTcMaxPages "
            "&& G <= tc::kWgRows;" in takes)
    assert const("kSlOwnMax") == 4
    own = body("inline int sl_own(")
    assert "const int fewest = (nc + kSlOwnMax - 1) / kSlOwnMax;" in own
    assert "return (nc + fewest - 1) / fewest;" in own
    for nc in range(5, 65):
        fewest = -(-nc // 4)
        assert -(-nc // fewest) in (3, 4)
    assert ("return D > wide_max_d(elt) ? kRouteRowSliced : kRouteRow;"
            in route_of)
    built = body("int built_dim(")
    assert "if (Dt > kRowOnlyPast) return (Dt + 63) / 64 * 64;" in built
    assert ("return Dt <= 32 ? 32 : Dt <= 64 ? 64 : Dt <= 128 ? 128 : Dt "
            "<= 192 ? 192" in " ".join(built.split()))
    assert "built_dim(D), D, S, P, NP, pps, scale," in src
    assert [ops.padded_head_dim(d) for d in (1, 20, 32, 33, 80, 96, 129,
                                             200, 256, 257, 288, 1000)] \
        == [32, 32, 32, 64, 128, 128, 192, 256, 256, 320, 320, 1024]
    assert (re.search(r"enum Route \{ kRouteSplit = 0, kRouteTc = 1, "
                      r"kRouteRow = 2,\s+kRouteRowSliced = 3, "
                      r"kRouteTcSliced = 4 \};", src)
            and tpa._ROUTES == ("split", "tc", "row", "row_sliced",
                                "tc_sliced"))
    assert "while (gp < G) gp <<= 1;" in body("inline int pad_group(")
    assert ("return G > kWgRows ? G : pad_group(G);"
            in body("inline int fold_of("))
    assert ("return (S + kSlotPad - 1) / kSlotPad * kSlotPad;"
            in body("inline int pad_slots("))
    assert ("S8 % 64 == 0 ? 64 : S8 % 32 == 0 ? 32 : S8 % 16 == 0 ? 16 : 8"
            in body("inline int box_rows("))
    chunk = body("int row_chunk_slots(")
    assert ("if (D > wide_max_d(elt)) return S < kKeyChunk ? S : kKeyChunk;"
            in chunk)
    assert ("const int fit = (kSmemMax - row_fixed_bytes(D)) / (4 * D * elt);"
            in chunk)
    assert "return S <= fit ? S : fit / kKeyChunk * kKeyChunk;" in chunk
    assert ("return D > kRowOnlyPast ? 2 * kWideRows * D * 4 : 0;"
            in body("constexpr int row_fixed_bytes("))
    assert ("return kSmemMax / (4 * kKeyChunk * elt + 2 * kWideRows * 4) / "
            "64 * 64;" in body("constexpr int wide_max_d("))
    assert "D > wide_max_d(sizeof(T))) return -1;" in body("int launch_wide(")
    assert ("D <= wide_max_d(sizeof(T))) return -1;"
            in body("int launch_sliced("))
    assert const("kSliceCols") == tpa._SLICE_COLS


@pytest.mark.parametrize("g,gp", [(1, 1), (2, 2), (3, 4), (5, 8), (6, 8),
                                  (7, 8), (8, 8), (33, 64), (64, 64)])
def test_group_padding(g, gp):
    """G padded to the power of two the C kernel folds (``pad_group``):
    the smallest one >= G, which divides the 64 folded rows, G itself
    where 64 % G == 0 (so those geometries keep their code path)."""
    got = 1 << (g - 1).bit_length()
    assert got == gp and 64 % got == 0 and (64 % g or got == g)


def _fold(g):
    """The tensor-core kernel's fold F (``fold_of``): G padded to a power
    of two up to ``_TC_ROWS`` heads, G itself past it."""
    return g if g > tpa._TC_ROWS else 1 << (g - 1).bit_length()


@pytest.mark.parametrize("g,f", [(1, 1), (7, 8), (33, 64), (64, 64),
                                 (65, 65), (71, 71), (96, 96), (128, 128),
                                 (200, 200)])
@pytest.mark.parametrize("t", [1, 2, 5, 64])
def test_fold_covers_every_row_once(g, f, t):
    """Folded row R of a kv head is (query column, head) = divmod(R, F)
    (F: gp up to G 64, G past it). Walked as the kernel walks it — tiles
    of 64 rows, ceil(T·F / 64) of them, each writing the rows with
    column < T and head < G — every (column, head) is written exactly
    once; the kernel's count of a tile's query columns, min(T - t0,
    (R0 + 63) // F - t0 + 1), covers every column a written row lies in;
    past G 64 a tile spans at most two columns, and up to G 64 exactly
    64 / gp (the parent's count, so those CTAs walk the same keys)."""
    assert _fold(g) == f
    written = []
    for y in range(-(-t * f // 64)):
        r0 = 64 * y
        t0 = r0 // f
        tn = min(t - t0, (r0 + 63) // f - t0 + 1)
        rows = [divmod(r0 + r, f) for r in range(64)]
        cols = {c for c, hd in rows if c < t and hd < g}
        assert cols <= set(range(t0, t0 + tn))
        if g > 64:
            assert (r0 + 63) // f - t0 <= 1
        else:
            assert tn == min(t - t0, 64 // f)
        written += [(c, hd) for c, hd in rows if c < t and hd < g]
    assert sorted(written) == [(c, hd) for c in range(t) for hd in range(g)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("q_start", [[0, 0], [5, 13]], ids=["qs0", "qs>0"])
@pytest.mark.parametrize("g,kv", [(71, 1), (65, 2)],
                         ids=["g71-kv1", "g65-kv2"])
def test_tile_ref_past_g64_matches_jax(g, kv, q_start, dtype):
    """The tensor-core kernel's arithmetic (``paged_attention_tile_ref``)
    at the groups it now folds flat: Falcon-7B's G 71 over one kv head,
    and G 65 over 2 kv heads (tiles whose rows are two runs of heads in
    two query columns on the card). At tiles of one page it walks the
    JAX kernel's own tiles (which pad G to 72): 2e-5 in both dtypes, as
    ``test_tile_ref_at_page_tiles_matches_jax``; at the card's 64-key
    tiles, the file's tolerance of the dtype. T 3, D 16, pages of 8, a
    6-entry table, rows starting at 0 and past it."""
    q, kp, vp, table = _geometry(2, 3, g * kv, kv, 16, 13, 8, 6,
                                 seed=g + kv)
    jdt, tdt, atol, rtol = _DTYPES[dtype]
    qs = np.asarray(q_start, np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(qs), interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
            torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
            torch.from_numpy(qs))
    got = tpa.paged_attention_tile_ref(*args, key_tile=8)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        tpa.paged_attention_tile_ref(*args, key_tile=64).numpy(), want,
        atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,cap", [(torch.float32, 1152),
                                       (torch.bfloat16, 1792)])
def test_wide_head_dim_cap(dtype, cap):
    """Past head dim 256 the row-tile kernel's wide form takes every
    multiple of 64 whose smallest chunk (8 slots of K and V, double
    buffered) fits 232,448 bytes beside q and the f32 accumulator of the
    CTA's 8 rows; the next multiple of 64 does not fit and runs the
    column-sliced form, whose shared memory (2 stages of q and K pieces,
    2 groups of V rows, the accumulator of a 512-column slice) fits
    whatever the head dim: every multiple of 64 is taken, as the JAX
    ``paged_supported`` takes it, and no other head dim past 256."""
    elt = torch.empty((), dtype=dtype).element_size()
    assert tpa.wide_max_head_dim(dtype) == cap
    assert 4 * 8 * cap * elt + 64 * cap <= tpa._SMEM_LIMIT
    assert 4 * 8 * (cap + 64) * elt + 64 * (cap + 64) > tpa._SMEM_LIMIT
    assert tpa.row_chunk_slots(cap, 4096, dtype) == 8
    # G 71 (the row-tile kernel's past 256 in both dtypes; bf16 calls at
    # G <= 64 run the sliced tensor-core kernel at every such head dim)
    assert tpa.kernel_route(64, 71, 1, cap, 16, 9, dtype) == "row"
    assert tpa.kernel_route(64, 71, 1, cap + 64, 16, 9, dtype) \
        == "row_sliced"
    for t in (1, 64):
        assert tpa.kernel_route(t, 8, 2, cap + 64, 16, 9, dtype) == (
            "tc_sliced" if dtype == torch.bfloat16 else "row_sliced")
    sliced = 48 * tpa._SLICE_COLS * elt + 8 * tpa._SLICE_COLS * 4
    assert sliced <= tpa._SMEM_LIMIT // 2
    assert tpa.paged_kernel_supported(cap, 16, dtype, 8, 2)
    assert tpa.paged_kernel_supported(cap + 64, 16, dtype, 8, 2)
    assert all(tpa.paged_kernel_supported(d, 7, dtype, 4, 2)
               for d in range(576, 4096 + 1, 64))
    # every other head dim too, at the next multiple of 64: 600 on the
    # wide form (640), cap + 32 on the sliced one (cap + 64)
    assert tpa.paged_kernel_supported(600, 16, dtype, 8, 2)
    assert tpa.paged_kernel_supported(cap + 32, 16, dtype, 8, 2)
    assert tpa.kernel_route(1, 71, 1, 600, 16, 9, dtype) == "row"
    assert tpa.kernel_route(1, 71, 1, cap - 32, 16, 9, dtype) == "row"
    assert tpa.kernel_route(1, 71, 1, cap + 32, 16, 9, dtype) \
        == "row_sliced"


@pytest.mark.parametrize("d,s,dtype,want", [
    (128, 16, torch.bfloat16, 16), (128, 227, torch.bfloat16, 227),
    (128, 228, torch.bfloat16, 224), (128, 300, torch.bfloat16, 224),
    (128, 113, torch.float32, 113), (128, 256, torch.float32, 112),
    (512, 16, torch.float32, 16), (512, 64, torch.float32, 24),
    (320, 7, torch.bfloat16, 7), (512, 4096, torch.bfloat16, 48),
    (576, 16, torch.bfloat16, 16), (576, 300, torch.bfloat16, 40),
    (1024, 16, torch.float32, 8), (1024, 16, torch.bfloat16, 16),
    (1024, 300, torch.bfloat16, 16), (1792, 64, torch.bfloat16, 8),
    (1856, 64, torch.bfloat16, 8), (1216, 300, torch.float32, 8),
    (2048, 7, torch.bfloat16, 7), (4096, 16, torch.float32, 8)])
def test_row_chunk_slots(d, s, dtype, want):
    """The row-tile kernel's chunk: the whole page where 4·S·D·bytes fit
    232,448 bytes of shared memory beside the CTA's fixed part (past head
    dim 256, q and the f32 accumulator of its 8 rows: 64·D bytes; so such
    pages run the loop they ran before chunks), else the most slots that
    fit in a multiple of 8; past the wide form's cap (its column-sliced
    form) one 8-key group, or the page where it is shorter."""
    c = tpa.row_chunk_slots(d, s, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    fixed = 64 * d if d > 256 else 0
    assert c == want
    if d > tpa.wide_max_head_dim(dtype):
        assert c == min(s, 8)
        return
    assert 4 * c * d * elt + fixed <= tpa._SMEM_LIMIT
    assert c == s or (c % 8 == 0 and 4 * (c + 8) * d * elt + fixed
                      > tpa._SMEM_LIMIT)


def test_binding_matches_the_c_entry():
    """The ctypes types ``_bind`` gives the C entry, one per parameter of
    ``bigdl_paged_attention`` in csrc/paged_attention.cu (a pointer as
    c_void_p, an int as c_int, the scale as c_float)."""
    import ctypes
    src = (Path(tpa.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    sig = src[src.index('extern "C" int bigdl_paged_attention('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    kinds = [ctypes.c_void_p if "*" in x else ctypes.c_float
             if x.split()[0] == "float" else ctypes.c_int for x in params]

    class _Fn:
        pass

    class _Lib:
        bigdl_paged_attention = _Fn()

    fn = tpa._bind(_Lib())
    assert fn.restype is ctypes.c_int
    assert fn.argtypes == kinds
    assert len(kinds) == 21


def test_dense_cache_page_size_matches_jax():
    for m in (13, 24, 64, 197, 320, 2048):
        assert tpa.dense_cache_page_size(m) == jpa.dense_cache_page_size(m)


def test_attend_grouped_matches_jax():
    """The plain version's core against the JAX serving helper itself."""
    from bigdl_tpu.models.transformer import serving as jsv
    rs = np.random.default_rng(6)
    q = rs.standard_normal((2, 3, 4, 8), np.float32)
    ck = rs.standard_normal((2, 10, 2, 8), np.float32)
    cv = rs.standard_normal((2, 10, 2, 8), np.float32)
    upto = np.asarray([[1, 2, 3], [7, 8, 9]], np.int32)
    want = jsv._attend_grouped(jnp.asarray(q), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(upto), 4, 0.3)
    got = tsv._attend_grouped(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv),
                              torch.from_numpy(upto).long(), 4, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


class TestNoSilentFallback:

    def test_default_device_needs_cuda(self):
        """Entry points default to the card and raise without one."""
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsv.PagedKVCache(1, num_pages=4, page_size=4, kv_heads=1,
                             head_dim=8)

    def test_non_cpu_tensor_never_takes_the_plain_version(self):
        """Only a CPU tensor selects the plain version; any other device
        must launch the kernel or raise."""
        q = torch.empty((1, 1, 4, 32), device="meta")
        kp = torch.empty((4, 8, 2, 32), device="meta")
        table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
        qs = torch.zeros((1,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            tpa.paged_attention(q, kp, kp, table, qs)

    def test_prefill_off_the_cpu_never_takes_a_plain_version(self):
        """A bf16 prefill call (the tensor-core route) off the CPU takes no
        plain version either: it must launch the kernel or raise."""
        assert tpa.kernel_route(64, 8, 2, 128, 16, 9, torch.bfloat16) == "tc"
        q = torch.empty((1, 64, 8, 128), dtype=torch.bfloat16, device="meta")
        kp = torch.empty((9, 16, 2, 128), dtype=torch.bfloat16,
                         device="meta")
        table = torch.zeros((1, 9), dtype=torch.int32, device="meta")
        qs = torch.zeros((1,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            tpa.paged_attention(q, kp, kp, table, qs)
        with pytest.raises(ValueError, match="CUDA device"):
            tpa.dense_cache_attention(
                q, torch.empty((1, 256, 2, 128), dtype=torch.bfloat16,
                               device="meta"),
                torch.empty((1, 256, 2, 128), dtype=torch.bfloat16,
                            device="meta"), qs)

    def test_kernel_mode_on_cpu_pools_raises(self):
        geom = (128, 16, torch.bfloat16, 8, 2)
        cpu, cuda = torch.device("cpu"), torch.device("cuda")
        with pytest.raises(ValueError, match="CUDA"):
            tsv._resolve_paged_kernel("kernel", cpu, *geom)
        with pytest.raises(ValueError, match="paged_kernel"):
            tsv._resolve_paged_kernel("interpret", cpu, *geom)
        assert tsv._resolve_paged_kernel("auto", cpu, *geom) == "dense"
        assert tsv._resolve_paged_kernel("auto", cuda, *geom) == "kernel"

    # (head dim, page size, pool dtype, heads, kv heads) -> the kernels
    # take it
    _GEOMETRIES = {
        "d32": ((32, 16, torch.bfloat16, 1, 1), True),
        # every other head dim runs at the next built one (zero columns
        # past it in the kernels' staged rows)
        "d96": ((96, 16, torch.bfloat16, 1, 1), True),
        "d16": ((16, 16, torch.bfloat16, 1, 1), True),
        "d192": ((192, 16, torch.bfloat16, 1, 1), True),
        "d192-f32": ((192, 16, torch.float32, 1, 1), True),
        # past 256 the row-tile kernel takes every call, at the next
        # multiple of 64 (288 at 320, where the JAX kernel leaves it to
        # its dense path): its wide form up to 1152 for f32 and 1792 for
        # bf16, its column-sliced form past them
        "d320": ((320, 16, torch.bfloat16, 1, 1), True),
        "d288": ((288, 16, torch.bfloat16, 1, 1), True),
        "d512-f32": ((512, 16, torch.float32, 8, 2), True),
        "d576": ((576, 16, torch.bfloat16, 1, 1), True),
        "d1024-f32": ((1024, 16, torch.float32, 8, 2), True),
        "d1152-f32": ((1152, 16, torch.float32, 8, 2), True),
        "d1216-f32": ((1216, 16, torch.float32, 8, 2), True),
        "d1792": ((1792, 300, torch.bfloat16, 8, 2), True),
        "d1856": ((1856, 16, torch.bfloat16, 8, 2), True),
        "d2048": ((2048, 16, torch.bfloat16, 8, 2), True),
        "d4096-f32": ((4096, 300, torch.float32, 8, 2), True),
        "d1880": ((1880, 16, torch.bfloat16, 8, 2), True),
        "d1000": ((1000, 16, torch.bfloat16, 1, 1), True),
        # every route takes any page size: the row-tile kernel streams a
        # page in chunks of slots
        "s128-f32-d128": ((128, 128, torch.float32, 1, 1), True),
        "s128-f16-d128": ((128, 128, torch.float16, 1, 1), False),
        "s112-f32-d128": ((128, 112, torch.float32, 1, 1), True),
        "s256-bf16-d128": ((128, 256, torch.bfloat16, 1, 1), True),
        "s256-bf16-d128-g4": ((128, 256, torch.bfloat16, 8, 2), True),
        "s1024-bf16-d256-g4": ((256, 1024, torch.bfloat16, 8, 2), True),
        # G 3, a 4097-entry table and pages of 300 slots: every route
        # takes any G, page size and table width; the same pools at a
        # head dim the JAX kernel leaves to its dense path are taken too
        "s256-bf16-d128-g3": ((128, 256, torch.bfloat16, 6, 2), True),
        "s256-bf16-d96-g3": ((96, 256, torch.bfloat16, 6, 2), True),
        "s256-bf16-d128-4097-pages": (
            (128, 256, torch.bfloat16, 8, 2), True),
        "s256-bf16-d288-4097-pages": (
            (288, 256, torch.bfloat16, 8, 2), True),
        "s300-bf16-d128": ((128, 300, torch.bfloat16, 1, 1), True),
        "s300-bf16-d96": ((96, 300, torch.bfloat16, 1, 1), True),
        "s12-bf16-d192": ((192, 12, torch.bfloat16, 1, 1), True),
        "s128-bf16-d128": ((128, 128, torch.bfloat16, 1, 1), True),
        "fp16": ((128, 16, torch.float16, 1, 1), False),
    }

    @pytest.mark.parametrize("case", sorted(_GEOMETRIES))
    def test_auto_consults_the_pool_geometry(self, case):
        """``paged_kernel_supported`` asks of a pool what the kernels
        take (float32 or bfloat16; any head dim, page size, G and table
        width); "auto" takes the
        kernel for a CUDA pool where it holds and refuses the pool where
        it does not, naming "dense"; "kernel" and "dense" are taken as
        asked."""
        geom, ok = self._GEOMETRIES[case]
        assert tpa.paged_kernel_supported(*geom) is ok
        cuda = torch.device("cuda")
        if ok:
            assert tsv._resolve_paged_kernel("auto", cuda, *geom) == "kernel"
        else:
            with pytest.raises(ValueError, match="paged_kernel='dense'"):
                tsv._resolve_paged_kernel("auto", cuda, *geom)
        assert tsv._resolve_paged_kernel("kernel", cuda, *geom) == "kernel"
        assert tsv._resolve_paged_kernel("dense", cuda, *geom) == "dense"
        assert tsv._resolve_paged_kernel("auto", torch.device("cpu"),
                                         *geom) == "dense"

    def test_auto_refuses_unsupported_pools_off_the_cpu(self):
        """A prefill/decode step over a pool off the CPU whose geometry
        the kernel does not take (float16) raises under "auto" instead of
        taking the dense path unseen (meta pools stand in for the
        card's); "dense" is taken as asked, and CPU pools take it under
        "auto". Head dim 96, which the kernels refused before they took
        every head dim, takes the kernel."""
        class _Model:
            lm_meta = dict(num_layers=1, num_heads=2, num_kv_heads=1)

        meta = tsv.PagedKVCache(1, 4, 16, 1, 96, torch.float16,
                                device="meta")
        with pytest.raises(ValueError, match="head dim 96"):
            tsv._meta_statics(_Model, "auto", meta)
        assert tsv._meta_statics(_Model, "dense", meta)["paged_kernel"] \
            == "dense"
        meta = tsv.PagedKVCache(1, 4, 16, 1, 96, torch.bfloat16,
                                device="meta")
        assert tsv._meta_statics(_Model, "auto", meta)["paged_kernel"] \
            == "kernel"
        cpu = tsv.PagedKVCache(1, 4, 16, 1, 96, torch.bfloat16,
                               device="cpu")
        assert tsv._meta_statics(_Model, "auto", cpu)["paged_kernel"] \
            == "dense"


def test_auto_is_route_aware_off_the_cpu():
    """The batcher's step path (``_meta_statics``, meta pools standing in
    for the card's) at the serving heads (8 over 2 kv heads): bf16 pages
    of 256 slots, head dim 192 and an f32 pool of 128-slot pages at D 128
    (256 KB a page of K and V, which the row-tile kernel streams in
    chunks) take the kernels, and so does head dim 96 (Phi-3-mini's),
    which the JAX kernel leaves to its dense path; a float16 pool raises
    before any work."""
    class _Model:
        lm_meta = dict(num_layers=1, num_heads=8, num_kv_heads=2)

    for s, d, dtype, ok in ((256, 128, torch.bfloat16, True),
                            (16, 192, torch.bfloat16, True),
                            (16, 192, torch.float32, True),
                            (128, 128, torch.float32, True),
                            (16, 96, torch.bfloat16, True),
                            (16, 96, torch.float16, False)):
        meta = tsv.PagedKVCache(1, 4, s, 2, d, dtype, device="meta")
        if ok:
            assert tsv._meta_statics(_Model, "auto", meta)[
                "paged_kernel"] == "kernel"
        else:
            with pytest.raises(ValueError, match="paged_kernel='dense'"):
                tsv._meta_statics(_Model, "auto", meta)
        assert tsv._meta_statics(_Model, "dense", meta)[
            "paged_kernel"] == "dense"


def test_wrapper_refuses_by_the_calls_route(monkeypatch):
    """The wrapper's own check no longer depends on the call's route: at
    bf16 D 128 pages of 256 slots a prefill call with G 3 (the row-tile
    route, which streams such pages in chunks) passes every check as one
    with G 4 (the tensor-core route) does, and so does the same call at
    head dim 288 (the row-tile kernel at 320) and 20 (its element-wise
    row staging); a float16 pool is refused as a geometry. Meta tensors
    stand in for the card's, with the device check waived, so the calls
    that pass stop only where the kernel library is built."""
    real = tpa._check

    def check(cond, msg):
        if "CUDA device" not in msg:
            real(cond, msg)
    monkeypatch.setattr(tpa, "_check", check)

    def call(h, d=128, dtype=torch.bfloat16):
        q = torch.empty((1, 32, h, d), dtype=dtype, device="meta")
        kp = torch.empty((4, 256, 2, d), dtype=dtype, device="meta")
        table = torch.zeros((1, 3), dtype=torch.int32, device="meta")
        qs = torch.zeros((1,), dtype=torch.int32, device="meta")
        tpa.paged_attention(q, kp, kp, table, qs)
    with pytest.raises(ValueError, match="pool geometry.*head dim 288"):
        call(6, 288, torch.float16)
    for h, d in ((6, 128), (8, 128), (6, 288), (8, 20)):
        with pytest.raises(Exception) as e:
            call(h, d)
        assert "pool geometry" not in str(e.value)


# (B, T, H, KV, D, page size, table entries, q_start of each row) at head
# dims the kernels are not built for, which they run at
# ``ops.padded_head_dim`` with zero columns past D: the train main's 16,
# Phi-2's 80, Phi-3-mini's 96 (4 heads over 4 kv heads here), 20 (bf16
# rows of 40 bytes, no 16-byte multiple: the row-tile kernel's
# element-wise staging) and 300 (past 256, 600-byte bf16 rows: the wide
# form's element-wise staging); decode (T·G <= 16) and prefill
_PADDED_CASES = {
    "d16-decode": (2, 1, 4, 2, 16, 16, 4, [0, 37]),
    "d16-prefill": (2, 20, 4, 4, 16, 16, 4, [0, 30]),
    "d80-decode": (2, 1, 4, 2, 80, 16, 4, [5, 50]),
    "d80-prefill": (2, 20, 4, 4, 80, 12, 5, [0, 25]),
    "d96-decode": (2, 1, 4, 4, 96, 16, 4, [3, 44]),
    "d96-prefill": (2, 20, 4, 4, 96, 16, 4, [0, 30]),
    "d20-decode": (2, 1, 4, 2, 20, 16, 4, [0, 37]),
    "d20-prefill": (2, 20, 6, 2, 20, 7, 8, [0, 30]),
    "d300-prefill": (2, 5, 4, 2, 300, 16, 3, [0, 20]),
}
# the route of each case by pool dtype (``kernel_route``, the C entry's)
_PADDED_ROUTES = {
    "d16-decode": ("split", "split"), "d16-prefill": ("row", "tc"),
    "d80-decode": ("split", "split"), "d80-prefill": ("row", "tc"),
    "d96-decode": ("split", "split"), "d96-prefill": ("row", "tc"),
    "d20-decode": ("split", "row"), "d20-prefill": ("row", "row"),
    "d300-prefill": ("row", "row"),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_PADDED_CASES))
def test_padded_head_dims_match_jax(case, dtype):
    """Paged attention at head dims the kernels run padded (D 16, 80, 96,
    20 and 300) against the JAX kernel in interpret mode (which runs any
    geometry there; its batcher serves these pools on its dense path),
    at the file's tolerances: the plain version, and the plain version
    of the kernel each call's route runs on the card (the split-KV
    merge at one and two pages a split, the tensor-core walk at its
    64-key tiles, the row-tile kernel's 8-key groups). The route is
    pinned: bf16 rows of 40 and 600 bytes (D 20, 300) take the row-tile
    kernel whatever T·G, f32 D 20 (80-byte rows) the split kernel."""
    b, t, h, kv, d, s, p, starts = _PADDED_CASES[case]
    tdt = _DTYPES[dtype][1]
    route = tpa.kernel_route(t, h, kv, d, s, p, tdt)
    assert route == _PADDED_ROUTES[case][dtype == "bf16"]
    assert tpa.paged_kernel_supported(d, s, tdt, h, kv)
    q, kp, vp, table = _geometry(b, t, h, kv, d, b * p + 1, s, p, seed=d)
    _compare(q, kp, vp, table, starts, dtype)
    refs = {"split": [functools.partial(tpa.paged_attention_split_ref,
                                        pages_per_split=pps)
                      for pps in (1, 2)],
            "tc": [functools.partial(tpa.paged_attention_tile_ref,
                                     key_tile=64)],
            "row": [tpa.paged_attention_row_ref]}[route]
    for fn in refs:
        _compare(q, kp, vp, table, starts, dtype, fn=fn)


def test_kernel_route_by_row_bytes():
    """At every head dim up to 256 the route is the built head dim's,
    except where a pool row (d elements) is no multiple of 16 bytes:
    bf16 d % 8 != 0 and f32 d % 4 != 0 take the row-tile kernel, decode
    and prefill alike."""
    for d, (dtype, vec) in itertools.product(
            range(1, 257), ((torch.bfloat16, 8), (torch.float32, 4))):
        decode = tpa.kernel_route(1, 8, 2, d, 16, 9, dtype)
        prefill = tpa.kernel_route(64, 8, 2, d, 16, 9, dtype)
        if d % vec:
            assert decode == prefill == "row", (dtype, d)
        else:
            assert decode == "split", (dtype, d)
            assert prefill == ("tc" if dtype == torch.bfloat16
                               else "row"), (dtype, d)

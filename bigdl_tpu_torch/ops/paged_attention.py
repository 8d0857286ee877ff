"""Paged attention: grouped causal attention of q straight off the KV
page pool (counterpart of ``bigdl_tpu/ops/pallas/paged_attention.py``).

``paged_attention`` walks each row's block table with an online softmax
— on a CUDA tensor through the hand-written Hopper kernels of
``csrc/paged_attention.cu`` (built at first use, see ``_build.py``), on a
CPU tensor through ``paged_attention_ref``, its plain PyTorch version:
the ``_paged_view`` gather of every row's pages into a dense cache
followed by ``_attend_grouped``. The choice follows the tensor's device
alone; on a CUDA tensor the wrapper launches the kernel or raises.

On the card the C entry picks the kernel by dtype and shape
(``kernel_route`` mirrors its choice, and each call holds the mirror to
the route the entry reports):

- ``"split"``: a call whose T·G query rows per kv head fit one tile (T·G
  <= 16: every decode step) runs the split-KV decode kernel — the key
  range cut into splits of ``decode_split_pages`` pages, one CTA per
  (row, kv head, split) writing an f32 partial (max, sum, accumulator) to
  a workspace allocated here, the last CTA of each (row, kv head) merging
  them; ``paged_attention_split_ref`` is its plain version.
- ``"tc"``: a bf16 call with more rows (prefill, and decode past 16
  rows: Falcon-7B's 71 heads over one kv head) at head dim <= 256 runs
  the tensor-core prefill kernel at any page size and any G — ``wgmma``
  products on tiles of 64 folded query rows (the G heads of a kv head
  padded to a power of two up to G 64, past it folded flat: a tile then
  spans two query columns) and 64 keys (each page padded to a multiple
  of 8 slots) that TMA reads straight off the pools through the block
  table — unless the table holds more than 4096 entries a row;
  ``paged_attention_tile_ref`` is its arithmetic in its order.
- ``"tc_sliced"``: a bf16 call past head dim 256 (pool rows a multiple
  of 16 bytes, G <= 64, p <= 4096; decode too, which it runs in a fifth
  of the row-tile kernels' time on an NVIDIA H100 80GB HBM3 at 700 W)
  runs the tensor-core prefill with its output's columns sliced: a CTA
  of 64 folded query rows owns 3 or 4 64-column chunks of the output,
  sums every score over all of D in 64-column chunks (the same order in
  every slice, so every slice forms the same running max and sum) and
  adds P·V for its chunks alone; ``paged_attention_tile_ref`` is its
  arithmetic in its order too.
- ``"row"``: every other call — f32 pools, tables past 4096 entries,
  and the calls past head dim 256 that ``"tc_sliced"`` does not take
  (f32, unaligned rows, G past 64) — runs the row-tile kernel on
  the CUDA cores, which streams each page in chunks of
  ``row_chunk_slots`` slots (past head dim 256 with D a runtime value,
  q and its accumulator in shared memory); ``paged_attention_row_ref``
  is its arithmetic in its order.
- ``"row_sliced"``: past :func:`wide_max_head_dim` (1152 for f32 pools,
  1792 for bf16), where q and the accumulator of the row-tile kernel's
  wide form no longer fit beside a chunk, the same arithmetic in the
  same order with the output's columns sliced (512 a CTA) and q and K
  staged in column pieces: shared memory no longer grows with D, so
  every multiple of 64 runs.

Every head dim D >= 1 runs, padded inside the kernels (the pools are the
whole cache, never copied): each runs at ``ops.padded_head_dim`` (32,
64, 128, 192 or 256, past 256 the next multiple of 64) with zeros past D
in its staged q and K/V rows, and stores D columns. A pool row of D·elt
bytes that is no multiple of 16 (bf16 D % 8, f32 D % 4) cannot be read in
16-byte copies or by TMA, so such calls take the row-tile kernel, which
stages those rows element by element.

``dense_cache_attention`` serves a dense per-row (B, M, KV, D) cache
through the same kernel: the cache is a pool of ``M // S`` contiguous
pages per row with an identity block table (a reshape, not a copy).

``launches`` counts wrapper calls that launched a kernel, so a run can
show its main path went through the kernel; ``split_launches``,
``tc_launches`` and ``tc_sliced_launches`` count the calls among them
that ran the split-KV decode, the tensor-core prefill and its sliced
form past head dim 256, ``unaligned_launches`` those whose pool rows
the row-tile kernel staged element by element.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import padded_head_dim

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_split_ref", "paged_attention_tile_ref",
           "paged_attention_row_ref", "decode_split_pages", "kernel_route",
           "row_chunk_slots",
           "dense_cache_attention", "dense_cache_page_size",
           "paged_kernel_supported", "wide_max_head_dim", "launches",
           "split_launches", "tc_launches", "tc_sliced_launches",
           "unaligned_launches"]

_NEG = -1e9  # finite mask value, as in the JAX package
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
#: keys the row-tile kernel scores per online-softmax update (kKeyChunk)
_KEY_CHUNK = 8
#: head dims past which every call runs the row-tile kernel (kRowOnlyPast
#: in csrc/paged_attention.cu)
_ROW_ONLY_PAST = 256
#: query rows a CTA of the row-tile kernel past head dim 256 holds, whose
#: q and f32 accumulator it keeps in shared memory (kWideRows)
_WIDE_ROWS = 8
#: output columns a CTA of the row-tile kernel's sliced form owns
#: (kSliceCols)
_SLICE_COLS = 512
#: query rows (T·G) per kv head up to which the C entry takes the split-KV
#: decode kernel (kSplitRows in csrc/paged_attention.cu)
_SPLIT_ROWS = 16
_SPLIT_MAX_PAGES = 4096
#: folded query rows a warpgroup of the tensor-core prefill kernel holds,
#: the most G it pads to a power of two (which divides them; past it the
#: fold is G itself), the block-table entries a CTA of it stages in
#: shared memory, and the multiple of slots its walk pads each page to
#: (kWgRows, kTcMaxPages, kSlotPad in csrc/paged_attention.cu)
_TC_ROWS = 64
_TC_MAX_PAGES = 4096
_SLOT_PAD = 8
#: the C entry's route codes
_ROUTES = ("split", "tc", "row", "row_sliced", "tc_sliced")
#: the C entry's own error codes (others: 1000 + a refused tensor map's
#: CUresult, or the CUDA error of the launch)
_ERRORS = {-1: "a head dim the kernels were not built for",
           -2: "a pool dtype the route does not take",
           -3: "a split call without a workspace, counters or pages per "
               "split",
           -4: "a split whose page ids do not fit shared memory",
           -5: "no tensor-map encoder in the driver"}

#: wrapper calls that launched a kernel since import (reset by assigning 0)
launches = 0
#: calls that ran the split-KV decode kernel, among ``launches``
split_launches = 0
#: calls that ran the tensor-core prefill kernel, among ``launches``
tc_launches = 0
#: calls that ran its column-sliced form past head dim 256, among
#: ``launches``
tc_sliced_launches = 0
#: calls whose pool rows are no multiple of 16 bytes (staged element by
#: element on the row-tile kernel), among ``launches``
unaligned_launches = 0
#: per (CUDA device, stream): int32 counters, one per (row, kv head),
#: that the split-KV kernel needs zeroed and leaves zeroed (a stream's
#: calls run in order, so they can share them)
_counters: dict = {}


def _fixed_bytes(head_dim: int) -> int:
    """Shared memory a row-tile CTA keeps beside its K/V chunks
    (``row_fixed_bytes``): q and the f32 accumulator of the wide kernel's
    rows past head dim 256, none below."""
    return 2 * _WIDE_ROWS * head_dim * 4 if head_dim > _ROW_ONLY_PAST else 0


@functools.cache
def wide_max_head_dim(dtype) -> int:
    """The largest head dim, a multiple of 64, the row-tile kernel's wide
    form takes past 256 for pools of ``dtype`` (``wide_max_d``): its
    smallest chunk (8 slots of K and V, double buffered, 4·8·D·bytes)
    beside q and the accumulator (64·D bytes) within 232,448 bytes of
    shared memory — 1152 for float32 pools, 1792 for bfloat16 ones.
    Past it the sliced form runs (route ``"row_sliced"``)."""
    elt = dtype.itemsize
    return (_SMEM_LIMIT // (4 * _KEY_CHUNK * elt + 2 * _WIDE_ROWS * 4)
            // 64 * 64)


def paged_kernel_supported(head_dim: int, page_size: int, dtype,
                           num_heads: int, num_kv_heads: int) -> bool:
    """Pool geometries the kernels take (the counterpart of the
    reference's ``paged_supported``), for pools of ``num_kv_heads`` kv
    heads serving ``num_heads`` query heads: float32 or bfloat16, G =
    heads / kv heads whole, any head dim (run at ``padded_head_dim``
    with zero columns past it; past :func:`wide_max_head_dim` the
    row-tile kernel slices its output's columns, so no head dim is
    capped).

    Every route takes any page size and table width: the split-KV kernel
    stages key rows, not pages; the tensor-core kernel pads each page to
    a multiple of 8 slots, which TMA fills with zeros; the row-tile
    kernel streams a page in chunks of :func:`row_chunk_slots` slots. So
    every pool of those dtypes is taken (the JAX ``paged_supported``'s,
    S % 8 == 0 and D a multiple of 64, among them, and those it serves
    on its dense path), pages of any size, any G, any table width."""
    return (dtype in _DTYPE_CODES and head_dim >= 1
            and page_size >= 1 and num_kv_heads >= 1
            and num_heads % num_kv_heads == 0)


def row_chunk_slots(head_dim: int, page_size: int, dtype) -> int:
    """Slots of a page the row-tile kernel stages at a time (its C, from
    ``row_chunk_slots`` in csrc/paged_attention.cu): the whole page where
    K and V, double buffered (4·S·D·bytes), fit a block's 232,448 bytes
    of shared memory beside the CTA's fixed part (past head dim 256, q
    and the accumulator: 64·D bytes), else the most slots that do, in a
    multiple of the 8 keys it scores per softmax update (so its
    arithmetic is the same whatever the chunk); past
    :func:`wide_max_head_dim` one 8-key group (the sliced form). Shared
    memory holds rows of ``padded_head_dim`` columns."""
    head_dim = padded_head_dim(head_dim)
    if head_dim > _ROW_ONLY_PAST and head_dim > wide_max_head_dim(dtype):
        return min(page_size, _KEY_CHUNK)
    elt = dtype.itemsize
    fit = (_SMEM_LIMIT - _fixed_bytes(head_dim)) // (4 * head_dim * elt)
    return page_size if page_size <= fit else fit // _KEY_CHUNK * _KEY_CHUNK


def kernel_route(t: int, h: int, kv: int, d: int, s: int, p: int,
                 dtype) -> str:
    """The kernel the C entry runs for q (B, t, h, d) against pools of
    pages of ``s`` slots, ``kv`` kv heads and ``dtype``, through a table of
    ``p`` entries a row, by ``padded_head_dim``: past 256
    ``"tc_sliced"`` (bf16 pools, rows of a multiple of 16 bytes, G <= 64,
    p <= 4096; decode too), else ``"row"`` (``"row_sliced"`` past
    :func:`wide_max_head_dim`); up to 256 ``"row"``
    where a pool row of ``d`` elements is no multiple of 16 bytes (bf16 d
    % 8, f32 d % 4: no 16-byte copy or TMA map reads it), else
    ``"split"`` (T·G <= 16 query rows per kv head), ``"tc"`` (bf16 at any
    page size and any G, p <= 4096; Falcon-7B's decode, T·G 71, among
    them) or ``"row"``. So the row-tile kernel keeps four cases: f32
    pools, rows that are no multiple of 16 bytes, tables wider than 4096
    entries, and past head dim 256 G past 64. Shapes and dtype only, as
    the C entry's ``route_of``; the wrapper raises if the entry reports
    another route."""
    g = h // kv
    built = padded_head_dim(d)
    if built > _ROW_ONLY_PAST:
        if (dtype == torch.bfloat16 and d * 2 % 16 == 0
                and g <= _TC_ROWS and p <= _TC_MAX_PAGES):
            return "tc_sliced"
        return "row_sliced" if built > wide_max_head_dim(dtype) else "row"
    if d * dtype.itemsize % 16:
        return "row"
    if t * g <= _SPLIT_ROWS:
        return "split"
    if dtype == torch.bfloat16 and p <= _TC_MAX_PAGES:
        return "tc"
    return "row"


def _paged_view(pool, table):
    """(num_pages, S, KV, D) pool + (B, P) table -> (B, P*S, KV, D)
    gathered per-row cache view (the logical dense cache)."""
    b, p = table.shape
    g = pool[table.reshape(-1).long()]           # (B*P, S, KV, D)
    s, kv, d = pool.shape[1:]
    return g.reshape(b, p * s, kv, d)


def _attend_grouped(q, ck, cv, upto, num_heads, scale):
    """Grouped causal attention of q (B,T,H,D) against a cached view
    (B, M, KV, D), masked to key positions <= ``upto`` (B, T) per row.
    Cache-dtype operands with f32 accumulation (the operands are widened
    to f32, where a product of two bf16 values is exact); returns f32."""
    b, t, _, hd = q.shape
    kv = ck.shape[2]
    g = num_heads // kv
    qg = q.reshape(b, t, kv, g, hd).to(ck.dtype)
    s = torch.einsum("btkgd,bmkd->bkgtm", qg.float(), ck.float()) * scale
    kpos = torch.arange(ck.shape[1], device=ck.device)
    s = torch.where(kpos > upto[:, None, None, :, None], _NEG, s)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgtm,bmkd->btkgd", p.float(), cv.float())
    return o.reshape(b, t, num_heads, hd)


def paged_attention_ref(q, kp, vp, table, q_start, *, scale=None):
    """Plain PyTorch version of :func:`paged_attention` (same arguments,
    same result): gather the dense view, attend with the causal mask
    ``key position <= q_start + t``."""
    t, d = q.shape[1], q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    upto = (q_start.long()[:, None]
            + torch.arange(t, device=q.device)[None, :])
    return _attend_grouped(q, _paged_view(kp, table), _paged_view(vp, table),
                           upto, q.shape[2], scale)


def paged_attention_split_ref(q, kp, vp, table, q_start, *,
                              pages_per_split, scale=None):
    """Plain PyTorch version of the split-KV decode kernels (same
    arguments as :func:`paged_attention`, same result up to where p is
    rounded): the key range is cut into splits of ``pages_per_split``
    pages; each split live for a row (starting at or before its last key
    ``q_start + T - 1``) gives per query row its max m_s over the split's
    scores (masked keys at -1e9, keys past the last unread), the sum l_s
    of p = exp(score - m_s) and acc_s = p rounded to the pool dtype · V;
    then o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the live
    splits. For the tests and ``chip_smoke.py``; no path calls it."""
    b, t, h, d = q.shape
    s_, kv = kp.shape[1], kp.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    width = pages_per_split * s_
    n_split = -(-table.shape[1] // pages_per_split)
    ck, cv = _paged_view(kp, table), _paged_view(vp, table)
    pad = n_split * width - ck.shape[1]
    ck = torch.nn.functional.pad(ck, (0, 0, 0, 0, 0, pad))
    cv = torch.nn.functional.pad(cv, (0, 0, 0, 0, 0, pad))
    qs = q_start.long()
    kpos = torch.arange(n_split * width, device=q.device)
    upto = qs[:, None] + torch.arange(t, device=q.device)[None, :]
    qg = q.reshape(b, t, kv, g, d).to(kp.dtype)
    sc = torch.einsum("btkgd,bmkd->bkgtm", qg.float(), ck.float()) * scale
    sc = torch.where(kpos > upto[:, None, None, :, None], _NEG, sc)
    read = kpos[None, :] <= (qs + t - 1)[:, None]        # keys a CTA reads
    sc = torch.where(read[:, None, None, None, :], sc, -torch.inf)
    sc = sc.reshape(b, kv, g, t, n_split, width)
    m = sc.amax(-1)                                      # -inf: dead split
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(sc - m_safe[..., None])
    l_ = p.sum(-1)
    acc = torch.einsum("bkgtsw,bswkd->bkgtsd", p.to(kp.dtype).float(),
                       cv.reshape(b, n_split, width, kv, d).float())
    e = torch.exp(m - m.amax(-1, keepdim=True))          # 0 for dead splits
    o = (e[..., None] * acc).sum(-2) / (e * l_).sum(-1)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


def _online_over_spans(q, kp, vp, table, q_start, spans, scale):
    """The online softmax of the tile plain versions: scores of q against
    each row's gathered view (keys past q_start + t at the finite -1e9,
    keys at or past ``n``, the view's end, at -inf), walked over the key
    ``spans`` (start, end) in order — m_new = max(m, span max), p =
    exp(score - m_new), l = l·e^(m - m_new) + sum p, acc = acc·e^(m -
    m_new) + (p rounded to the pool dtype)·V — then o = acc / l."""
    b, t, h, d = q.shape
    kv = kp.shape[2]
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
    ck, cv = _paged_view(kp, table), _paged_view(vp, table)
    n = ck.shape[1]
    pad = max(end for _, end in spans) - n
    ck = torch.nn.functional.pad(ck, (0, 0, 0, 0, 0, pad))
    cv = torch.nn.functional.pad(cv, (0, 0, 0, 0, 0, pad))
    kpos = torch.arange(n + pad, device=q.device)
    upto = (q_start.long()[:, None]
            + torch.arange(t, device=q.device)[None, :])
    qg = q.reshape(b, t, kv, g, d).to(kp.dtype)
    sc = torch.einsum("btkgd,bmkd->bkgtm", qg.float(), ck.float()) * scale
    sc = torch.where(kpos > upto[:, None, None, :, None], _NEG, sc)
    sc = torch.where(kpos >= n, -torch.inf, sc)
    m = torch.full(sc.shape[:-1], -torch.inf, device=q.device)
    l_ = torch.zeros_like(m)
    acc = torch.zeros(sc.shape[:-1] + (d,), device=q.device)
    for k0, k1 in spans:
        st = sc[..., k0:k1]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l_ = l_ * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgtm,bmkd->bkgtd", p.to(kp.dtype).float(),
            cv[:, k0:k1].float())
        m = m_new
    o = acc / l_[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


def paged_attention_tile_ref(q, kp, vp, table, q_start, *, key_tile,
                             scale=None):
    """Plain PyTorch version of the tensor-core prefill kernel's
    arithmetic, in its order (same arguments as :func:`paged_attention`):
    an online softmax over tiles of ``key_tile`` keys — m_new = max(m,
    tile max), p = exp(score - m_new), l = l·e^(m - m_new) + sum p, acc =
    acc·e^(m - m_new) + (p rounded to the pool dtype)·V — then o = acc /
    l. Keys past q_start + t score the finite -1e9; keys past the table's
    end, -inf.

    The tiles walk the padded slot space of the kernel: each page of S
    slots padded to S8, the next multiple of 8 (``kSlotPad``; slot s of
    page j is padded key j·S8 + s), and each tile of ``key_tile`` padded
    keys takes the logical keys among them, so at S % 8 != 0 the spans
    are uneven (the padded slots are no keys: the kernel scores them -inf,
    which weighs 0). At S % 8 == 0 the tiles are ``key_tile`` keys of the
    view each, and at ``key_tile`` = the page size they are the JAX
    kernel's tiles. For the tests and ``chip_smoke.py``; no path calls
    it."""
    s = kp.shape[1]
    s8 = -(-s // _SLOT_PAD) * _SLOT_PAD
    n_pad = table.shape[1] * s8

    def logical(k):              # keys of the view before padded key k
        return k // s8 * s + min(k % s8, s)
    return _online_over_spans(
        q, kp, vp, table, q_start,
        [(logical(k0), logical(min(k0 + key_tile, n_pad)))
         for k0 in range(0, n_pad, key_tile)], scale)


def paged_attention_row_ref(q, kp, vp, table, q_start, *, scale=None):
    """Plain PyTorch version of the row-tile kernel's arithmetic, in its
    order (same arguments as :func:`paged_attention`): the online softmax
    of :func:`paged_attention_tile_ref` over groups of 8 keys that start
    at each multiple of 8 of each page (the last group of a page of S %
    8 != 0 slots is short). Whatever chunk of a page the kernel stages
    (``row_chunk_slots``), it scores the same groups in the same order.
    For the tests and ``chip_smoke.py``; no path calls it."""
    s = kp.shape[1]
    return _online_over_spans(
        q, kp, vp, table, q_start,
        [(j * s + c, j * s + min(c + _KEY_CHUNK, s))
         for j in range(table.shape[1]) for c in range(0, s, _KEY_CHUNK)],
        scale)


def decode_split_pages(b: int, kv: int, p: int, sms: int) -> int:
    """Pages per split of the split-KV decode kernel for ``b`` rows, ``kv``
    kv heads, ``p`` block-table entries a row, on a card of ``sms`` SMs:
    as many splits as give two CTAs an SM were every row's table full,
    at most one a page, and at most ``_SPLIT_MAX_PAGES`` pages a split
    (their ids are staged in shared memory). Host integers only: the
    kernel never has the lengths (``q_start``, on the card) read back to
    choose it."""
    n_split = max(1, min(p, -(-2 * sms // (b * kv))),
                  -(-p // _SPLIT_MAX_PAGES))
    return -(-p // n_split)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bind(lib):
    """The C entry ``bigdl_paged_attention`` of a built
    csrc/paged_attention.cu (or an edited copy of it), typed."""
    fn = lib.bigdl_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.cache
def _kernel_fn():
    """The C entry of csrc/paged_attention.cu, built at first use."""
    from bigdl_tpu_torch.ops._build import load_library
    return _bind(load_library("paged_attention.cu"))


def _check(cond, msg):
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def _launch(fn, q, kp, vp, table, q_start, scale, route):
    """Run ``fn``, a C entry ``bigdl_paged_attention`` (``_bind``), on a
    call the wrapper has checked, with the workspace and counters that
    ``route`` needs (the split-KV kernel's); returns the f32 output and
    the route the entry reports. Raises on an error code."""
    b, t, h, d = q.shape
    _, s, kv, _ = kp.shape
    p = table.shape[1]
    qc = q.to(kp.dtype).contiguous()
    if qc.data_ptr() % 16:          # the kernels copy q in 16-byte vectors
        qc = qc.clone()
    table = table.to(torch.int32).contiguous()
    q_start = q_start.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pps, ws, counters = 0, None, None
    if route == "split":
        # f32 (max, sum, accumulator at the built head dim) per (row, kv
        # head, split)
        pps = decode_split_pages(b, kv, p, _sm_count(q.device.index))
        ws = torch.empty(b * kv * -(-p // pps) * t * (h // kv)
                         * (padded_head_dim(d) + 2),
                         dtype=torch.float32, device=q.device)
        counters = _counters.get((q.device, stream))
        if counters is None or counters.numel() < b * kv:
            counters = torch.zeros(b * kv, dtype=torch.int32,
                                   device=q.device)
            _counters[(q.device, stream)] = counters
    took = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[kp.dtype], qc.data_ptr(), kp.data_ptr(),
                 vp.data_ptr(), table.data_ptr(), q_start.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 ctypes.byref(took), b, t, h, kv, d, s, p, kp.shape[0],
                 pps, float(scale), stream)
    took = (_ROUTES[took.value] if 0 <= took.value < len(_ROUTES)
            else took.value)
    if err:
        why = _ERRORS.get(err, f"tensor map refused (CUresult {err - 1000})"
                          if err >= 1000 else "CUDA error")
        raise RuntimeError(f"paged_attention {took} kernel launch failed "
                           f"(code {err}: {why})")
    return out, took


def paged_attention(q, kp, vp, table, q_start, *, scale=None):
    """Grouped causal attention of ``q`` (B, T, H, D) directly against
    the page pools — no dense per-row view on the card. Any head dim.

    ``kp``/``vp``: (num_pages, S, KV, D) pools (float32 or bfloat16;
    q is cast to their dtype); ``table``: (B, P) physical page ids, every
    entry a legal pool index; ``q_start``: (B,) absolute position of each
    row's first query column — column t attends key positions <=
    q_start + t. Returns (B, T, H, D) float32. On the card the call runs
    the kernel ``kernel_route`` names: the split-KV decode kernels (T·G
    <= 16 query rows per kv head; split count from shapes alone), the
    tensor-core prefill kernel (bf16, any G; past head dim 256 its
    column-sliced form, G <= 64, decode too), or the row-tile kernel (f32
    prefill, tables past 4096 entries, and past head dim 256 f32 and G
    past 64; past :func:`wide_max_head_dim` its column-sliced form)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kp, vp, table, q_start, scale=scale)
    global launches, split_launches, tc_launches, tc_sliced_launches
    global unaligned_launches
    b, t, h, d = q.shape
    _, s, kv, _ = kp.shape
    _check(q.is_cuda and all(x.device == q.device
                             for x in (kp, vp, table, q_start)),
           "q, pools, table and q_start must be on one CUDA device")
    _check(kp.shape == vp.shape and kp.shape[3] == d,
           f"pool shapes {tuple(kp.shape)}/{tuple(vp.shape)} do not match "
           f"q {tuple(q.shape)}")
    _check(h % kv == 0, f"{h} query heads not divisible by {kv} kv heads")
    p = table.shape[1] if table.dim() == 2 else 0
    want = kernel_route(t, h, kv, d, s, p, kp.dtype)
    _check(kp.dtype in _DTYPE_CODES and vp.dtype == kp.dtype and d >= 1,
           f"pool geometry the kernel does not take: head dim {d}, pool "
           f"dtype {kp.dtype}/{vp.dtype} (need float32 or bfloat16)")
    _check(kp.is_contiguous() and vp.is_contiguous(),
           "pools must be contiguous")
    _check(kp.data_ptr() % 16 == 0 and vp.data_ptr() % 16 == 0,
           "pools must be 16-byte aligned")
    _check(table.dim() == 2 and table.shape[0] == b
           and q_start.shape == (b,),
           f"table {tuple(table.shape)} / q_start {tuple(q_start.shape)} "
           f"do not match batch {b}")
    scale = d ** -0.5 if scale is None else scale
    out, took = _launch(_kernel_fn(), q, kp, vp, table, q_start, scale,
                        want)
    if took != want:
        raise RuntimeError(f"paged_attention: the C entry ran the {took} "
                           f"kernel where kernel_route names {want}")
    launches += 1
    split_launches += want == "split"
    tc_launches += want == "tc"
    tc_sliced_launches += want == "tc_sliced"
    unaligned_launches += d * kp.dtype.itemsize % 16 != 0
    return out


def dense_cache_page_size(max_len: int, cap: int = 128,
                          floor: int = 8) -> int:
    """Page size the dense-cache view splits a (B, M, KV, D) cache into:
    the largest divisor of M in [floor, cap], else M itself (one page per
    row)."""
    return next((s for s in range(min(cap, max_len), floor - 1, -1)
                 if max_len % s == 0), max_len)


def dense_cache_attention(q, ck, cv, q_start, *, scale=None):
    """:func:`paged_attention` over a dense per-row cache (B, M, KV, D):
    the cache is a pool of ``M // S`` contiguous pages per row with the
    identity block table, so short rows skip their empty tail pages."""
    b, m, kv, d = ck.shape
    s = dense_cache_page_size(m)
    n = m // s
    pool_k = ck.reshape(b * n, s, kv, d)
    pool_v = cv.reshape(b * n, s, kv, d)
    table = (torch.arange(b, dtype=torch.int32, device=ck.device)[:, None]
             * n + torch.arange(n, dtype=torch.int32,
                                device=ck.device)[None, :])
    return paged_attention(q, pool_k, pool_v, table, q_start, scale=scale)

"""Paged KV cache, paged prefill/decode and the continuous batcher
(counterpart of ``bigdl_tpu/models/transformer/serving.py``).

- ``PagedKVCache``: per layer, (num_pages, page_size, kv_heads, head_dim)
  K and V pools shared by all sequences, and a host-side free list. The
  pools are updated in place (the JAX package rebinds new arrays).
- ``paged_prefill`` / ``paged_decode``: the JAX ``_impl`` bodies as eager
  PyTorch; the decode ``lax.scan`` is a Python loop. Attention goes
  through ``_attend_paged``, switched by ``paged_kernel``: "auto" (the
  CUDA kernel for pools on the card, refusing a geometry it does not
  take; the plain version for pools on the CPU), "kernel" or "dense"
  (the plain ``_paged_view`` +
  ``_attend_grouped`` version, on any device). There is no environment
  override: nothing outside the call turns the kernel off.
- ``ContinuousBatcher``: the host-side admit / decode-burst / retire loop.

Two places where JAX semantics do not carry over to torch: JAX drops a
scatter to an out-of-range page id and clamps an out-of-range gather,
torch raises (on the card, a device-side assert). So prefill writes only
the valid prompt columns (masked on the host), and decode keeps every
table gather in range (free slots sit at length 0 on the scratch page).

Not ported in this slice (ROADMAP.md): ``KVSnapshot``, suffix prefill,
``prefill_only`` and export/adopt; ``generate_ragged``,
``speculative_generate``; the AOT ``PagedStepCompilers``; the batcher's
metrics registry, compile watch, health check, trace spans and tracker
hooks.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bigdl_tpu_torch.models.transformer.generate import (
    GenerationConfig, _embed, _ffn, _linear, _ln, _model_parts, _proj,
    _sample, _split_heads)
# _attend_grouped and _paged_view live beside the kernel they are the
# plain version of; they are importable from here as in the JAX package
from bigdl_tpu_torch.ops.paged_attention import (  # noqa: F401
    _attend_grouped, _paged_view, paged_attention, paged_attention_ref,
    paged_kernel_supported)
from bigdl_tpu_torch.tensor import activation_dtype, resolve_device

__all__ = ["PagedKVCache", "paged_prefill", "paged_decode",
           "ContinuousBatcher", "PAGED_KERNEL_MODES"]

PAGED_KERNEL_MODES = ("auto", "dense", "kernel")


def _rope_rows(x, positions, theta: float = 10000.0):
    """Rotary embedding with per-row positions: ``x`` (B, T, H, D),
    ``positions`` (B, T) absolute positions. Split-half convention, f32
    angles, rotation in x's dtype (as ``nn.attention.apply_rope``)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs    # (B, T, hf)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)          # (B,T,1,hf)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _qkv(bp, x, num_heads, num_kv_heads):
    """LN + q/k/v projections split to heads."""
    mha_p = bp["0"]["1"]
    kv = num_kv_heads or num_heads
    h = _ln(bp["0"]["0"], x)
    q = _split_heads(_proj(mha_p, "q", h), num_heads)
    k = _split_heads(_proj(mha_p, "k", h), kv)
    v = _split_heads(_proj(mha_p, "v", h), kv)
    return q, k, v


def _embed_rows(ep, tokens, cols):
    """Token (+ learned position) embedding with per-row positions
    ``cols`` (B, T)."""
    vocab = ep["tok"].shape[0]
    y = ep["tok"][(tokens.long() - 1).clamp(0, vocab - 1)]
    if "pos" in ep:          # learned positions; absent under RoPE
        y = y + ep["pos"][cols.clamp(0, ep["pos"].shape[0] - 1)]
    return y


def _row_logits(params, num_layers, x, col):
    """LM-head logits of per-row column ``col`` (B,) of x (B, T, E)."""
    _, _, norm, head = _model_parts(params, num_layers)
    last = x[torch.arange(x.shape[0], device=x.device), col]
    return _linear(head, _ln(norm, last))


class PagedKVCache:
    """Block-table KV pool for continuous batching: per layer, K and V
    pools of (num_pages, page_size, kv_heads, head_dim) shared by all
    sequences; ``alloc``/``free`` manage pages host-side between decode
    bursts."""

    def __init__(self, num_layers, num_pages, page_size, kv_heads,
                 head_dim, dtype=None, *, device="cuda"):
        device = resolve_device(device)
        dtype = dtype or activation_dtype()
        self.num_pages, self.page_size = num_pages, page_size
        self.kv_heads, self.head_dim = kv_heads, head_dim
        self.num_layers = num_layers
        shape = (num_pages, page_size, kv_heads, head_dim)
        self.kp = [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(num_layers)]
        self.vp = [torch.zeros(shape, dtype=dtype, device=device)
                   for _ in range(num_layers)]
        self._free = list(range(num_pages - 1, -1, -1))   # host-side stack

    @property
    def device(self) -> torch.device:
        return self.kp[0].device

    def alloc(self, n_tokens: int) -> list[int]:
        """Reserve enough physical pages for ``n_tokens`` more tokens."""
        n = -(-n_tokens // self.page_size)
        if n > len(self._free):
            raise RuntimeError(f"paged cache exhausted: want {n} pages, "
                               f"{len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        """Return a finished sequence's pages to the pool."""
        self._free.extend(int(p) for p in pages)

    @property
    def pages_free(self) -> int:
        return len(self._free)


def _resolve_paged_kernel(mode, device: torch.device, head_dim: int,
                          page_size: int, dtype, num_heads: int,
                          num_kv_heads: int) -> str:
    """``paged_kernel=`` -> "kernel" or "dense" for pools of this geometry
    on ``device`` (``num_heads`` query heads over ``num_kv_heads`` kv
    heads): "auto" is the kernel off the CPU and the plain version on the
    CPU. A pool off the CPU whose geometry the kernels do not take
    (``paged_kernel_supported``) raises here under "auto", before any
    work: on the card the dense path is taken only when asked for.
    "kernel" raises at its first call for such a pool."""
    if mode not in PAGED_KERNEL_MODES:
        raise ValueError(f"paged_kernel must be one of "
                         f"{PAGED_KERNEL_MODES}, got {mode!r}")
    if mode == "kernel" and device.type != "cuda":
        raise ValueError("paged_kernel='kernel' needs the pools on a CUDA "
                         f"device, they are on {device}")
    if mode == "auto" and device.type == "cpu":
        return "dense"
    if mode == "auto" and not paged_kernel_supported(
            head_dim, page_size, dtype, num_heads, num_kv_heads):
        raise ValueError(
            f"paged_kernel='auto' on {device.type} pools but the kernels "
            f"do not take their geometry: head dim {head_dim}, pages of "
            f"{page_size} slots, {dtype}, {num_heads} heads over "
            f"{num_kv_heads} kv heads (need float32 or bfloat16 and kv "
            f"heads dividing the heads); "
            f"paged_kernel='dense' takes the plain path")
    return "kernel" if mode == "auto" else mode


def _attend_paged(q, kp, vp, table, q_start, scale, kernel: str):
    """One attention consumption of the page pool, switched: the kernel
    walks the block table page by page; "dense" gathers the view and
    attends over it. Both return (B, T, H, D) f32."""
    if kernel == "kernel":
        return paged_attention(q, kp, vp, table, q_start, scale=scale)
    return paged_attention_ref(q, kp, vp, table, q_start, scale=scale)


def _meta_statics(model, paged_kernel, cache: PagedKVCache):
    """The step functions' static arguments for ``model`` over
    ``cache``."""
    meta = model.lm_meta
    kernel = _resolve_paged_kernel(
        paged_kernel, cache.device, cache.head_dim, cache.page_size,
        cache.kp[0].dtype, meta["num_heads"],
        meta.get("num_kv_heads") or meta["num_heads"])
    return dict(num_layers=meta["num_layers"], num_heads=meta["num_heads"],
                rope=meta.get("pos_encoding", "learned") == "rope",
                num_kv_heads=meta.get("num_kv_heads"), paged_kernel=kernel)


@torch.no_grad()
def _paged_prefill_impl(params, cache: PagedKVCache, table, prompt,
                        lengths, *, num_layers, num_heads, rope=False,
                        num_kv_heads=None, paged_kernel="dense"):
    """Prefill right-padded prompts (B, Pmax) into the page pool; returns
    the LM-head logits (B, vocab) at each row's last prompt position.

    ``table`` (B, P), ``prompt`` (B, Pmax) and ``lengths`` (B,) are host
    arrays. Column j < lengths[i] of row i writes slot
    (table[i, j // S], j % S); padding columns write nothing — the
    columns to write are chosen on the host, because the JAX package's
    out-of-range "drop" page id would be an error in torch."""
    embed, blocks, _, _ = _model_parts(params, num_layers)
    dtype = activation_dtype()
    dev = cache.device
    s = cache.page_size
    b, pmax = prompt.shape
    w_row, w_col = np.nonzero(np.arange(pmax)[None, :] < lengths[:, None])
    to_dev = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    src = (to_dev(w_row), to_dev(w_col))
    dst = (to_dev(table[w_row, w_col // s]), to_dev(w_col % s))
    table_t = torch.as_tensor(table, dtype=torch.int32, device=dev)
    x = _embed(embed, torch.as_tensor(prompt, device=dev), 0).to(dtype)
    cols = torch.arange(pmax, device=dev).expand(b, pmax)
    # prefill query columns are row-uniform (0..Pmax-1): q_start is zero
    # for every row; padding columns compute junk that is never read
    q_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    scale = (x.shape[-1] // num_heads) ** -0.5
    for li in range(num_layers):
        q, k, v = _qkv(blocks[li], x, num_heads, num_kv_heads)
        if rope:
            q = _rope_rows(q, cols)
            k = _rope_rows(k, cols)
        cache.kp[li][dst] = k[src].to(cache.kp[li].dtype)
        cache.vp[li][dst] = v[src].to(cache.vp[li].dtype)
        o = _attend_paged(q, cache.kp[li], cache.vp[li], table_t, q_start,
                          scale, paged_kernel)
        o = o.reshape(x.shape).to(x.dtype)
        x = x + _proj(blocks[li]["0"]["1"], "out", o).to(activation_dtype())
        x = x + _ffn(blocks[li]["1"]["1"], _ln(blocks[li]["1"]["0"], x))
    return _row_logits(params, num_layers, x, to_dev(lengths - 1))


def paged_prefill(model, cache: PagedKVCache, table, prompts, *,
                  lengths=None, params=None, paged_kernel="auto"):
    """Prefill a mixed-length prompt batch into the paged pool.

    ``table``: (B, pages_per_seq) physical page ids covering each row's
    prompt and the tokens to be decoded after it. ``prompts``: a list of
    1-based id sequences — or, with ``lengths``, a right-padded
    (B, Pmax) array whose per-row true lengths are given (padding columns
    never write pages or logits). Returns (greedy first tokens (B,) as a
    tensor on the pool's device, lengths (B,) as a numpy array)."""
    params = model.params if params is None else params
    if lengths is None:
        lengths = np.asarray([len(p) for p in prompts], np.int32)
        batch = np.ones((len(prompts), int(lengths.max())), np.int32)
        for i, p in enumerate(prompts):
            batch[i, :len(p)] = np.asarray(p, np.int32)
    else:
        batch = np.asarray(prompts, np.int32)
        lengths = np.asarray(lengths, np.int32)
        if batch.ndim != 2 or lengths.shape != (batch.shape[0],):
            raise ValueError("explicit-lengths prefill needs a (B, Pmax) "
                             "array and (B,) lengths")
        if int(lengths.max()) > batch.shape[1]:
            raise ValueError(f"lengths {lengths.tolist()} exceed the "
                             f"padded width {batch.shape[1]}")
    table = np.asarray(table, np.int32)
    capacity = table.shape[1] * cache.page_size
    if int(lengths.max()) > capacity:
        raise ValueError(
            f"prompt of {int(lengths.max())} tokens exceeds the table's "
            f"{table.shape[1]} pages x {cache.page_size} slots "
            f"= {capacity}-token capacity")
    logits = _paged_prefill_impl(
        params, cache, table, batch, lengths,
        **_meta_statics(model, paged_kernel, cache))
    first = torch.argmax(logits.to(torch.float32), dim=-1) + 1
    return first, lengths


@torch.no_grad()
def _paged_decode_impl(params, cache: PagedKVCache, table, lengths, tok0,
                       *, num_layers, num_heads, n_new, temperature, top_k,
                       rope=False, num_kv_heads=None, paged_kernel="dense",
                       generator=None):
    """``n_new`` single-token steps through the paged pools. ``table``
    (B, P) int32, ``lengths`` (B,) tokens already cached per row and
    ``tok0`` (B,) the last sampled token, all tensors on the pool's
    device. Returns (tokens (B, n_new), lengths + n_new)."""
    embed, blocks, _, _ = _model_parts(params, num_layers)
    dtype = activation_dtype()
    s = cache.page_size
    b = tok0.shape[0]
    rows = torch.arange(b, device=tok0.device)
    zero = torch.zeros_like(lengths)
    tok, out = tok0, []
    for _ in range(n_new):
        cols = lengths[:, None]                   # (B, 1) write position
        x = _embed_rows(embed, tok[:, None], cols).to(dtype)
        scale = (x.shape[-1] // num_heads) ** -0.5
        # physical slot of this token: page table[b, len // S], row
        # len % S; every index is in range (checked by the caller)
        phys = table[rows, lengths // s].long()
        slot = lengths % s
        q_start = lengths.to(torch.int32)
        for li in range(num_layers):
            q, k, v = _qkv(blocks[li], x, num_heads, num_kv_heads)
            if rope:
                q = _rope_rows(q, cols)
                k = _rope_rows(k, cols)
            cache.kp[li][phys, slot] = k[:, 0].to(cache.kp[li].dtype)
            cache.vp[li][phys, slot] = v[:, 0].to(cache.vp[li].dtype)
            # the single query column sits at per-row position
            # ``lengths`` — the slot just written above
            o = _attend_paged(q, cache.kp[li], cache.vp[li], table,
                              q_start, scale, paged_kernel)
            o = o.reshape(x.shape).to(x.dtype)
            x = x + _proj(blocks[li]["0"]["1"], "out",
                          o).to(activation_dtype())
            x = x + _ffn(blocks[li]["1"]["1"], _ln(blocks[li]["1"]["0"],
                                                   x))
        logits = _row_logits(params, num_layers, x, zero)
        tok = _sample(logits, temperature, top_k, generator)
        out.append(tok)
        lengths = lengths + 1
    return torch.stack(out, dim=1), lengths


def paged_decode(model, cache: PagedKVCache, table, lengths, last_tokens,
                 n_new: int, *, config: GenerationConfig | None = None,
                 generator: torch.Generator | None = None, params=None,
                 paged_kernel="auto"):
    """Decode ``n_new`` tokens for every row through the paged pool.

    ``table``: (B, pages_per_seq) physical page ids; ``lengths``: (B,)
    tokens already cached; ``last_tokens``: (B,) the last sampled ids.
    Sampling beyond greedy draws from ``generator`` (a generator on the
    pool's device). Returns (tokens (B, n_new), updated lengths (B,)),
    both tensors on the pool's device; the pools are updated in place."""
    config = config or GenerationConfig(max_new_tokens=n_new)
    params = model.params if params is None else params
    table = np.asarray(table, np.int32)
    lengths = np.asarray(lengths, np.int32)
    capacity = table.shape[1] * cache.page_size
    if int(lengths.max()) + n_new > capacity:
        raise ValueError(
            f"decoding {n_new} tokens past length {int(lengths.max())} "
            f"exceeds the table's {capacity}-token capacity "
            f"({table.shape[1]} pages x {cache.page_size} slots)")
    dev = cache.device
    return _paged_decode_impl(
        params, cache, torch.as_tensor(table, device=dev),
        torch.as_tensor(lengths, dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(last_tokens, np.int64), device=dev),
        n_new=n_new, temperature=config.temperature, top_k=config.top_k,
        generator=generator,
        **_meta_statics(model, paged_kernel, cache))


class ContinuousBatcher:
    """Host-side continuous-batching loop over the paged cache.

    ``submit()`` queues requests; each ``step()`` admits queued requests
    into free slots (prompt prefilled into freshly allocated pages, its
    width bucketed to a power of two), decodes one fixed-shape burst for
    all ``max_batch`` slots, and retires rows that hit ``eos_id`` or
    their token budget (pages back to the pool); ``finished()`` hands
    back completed generations. Greedy decode. Free slots decode into a
    dedicated scratch page from length 0 and their outputs are
    discarded.

    ``ttft_s[request_id]`` holds each admitted request's time to first
    token (queue wait + prefill, seconds, closed by the first-token
    readback); the caller clears it.
    """

    def __init__(self, model, *, max_batch: int, num_pages: int,
                 page_size: int = 16, max_new_tokens: int = 32,
                 max_burst: int = 8, eos_id: int | None = None,
                 paged_kernel="auto"):
        meta = model.lm_meta
        self.model = model
        self.max_batch = max_batch
        self.max_new = max_new_tokens
        self.max_burst = max_burst
        self.eos_id = eos_id
        self.page_size = page_size
        tok = model.params["0"]["tok"]
        kv = meta.get("num_kv_heads") or meta["num_heads"]
        head_dim = tok.shape[1] // meta["num_heads"]
        # the longest admissible prompt: bucket + budget must fit the
        # model's positions; per-row allocations include max_burst
        # slack because a fixed burst can overshoot max_new before the
        # retire check runs (overshoot tokens are discarded, but their
        # cache writes must land in the row's own pages)
        self.max_prompt = meta["max_len"] - max_new_tokens
        self.pages_per_slot = -(-(self.max_prompt + max_new_tokens
                                  + max_burst) // page_size)
        _resolve_paged_kernel(paged_kernel, tok.device, head_dim,  # validate
                              page_size, activation_dtype(),       # now
                              meta["num_heads"], kv)
        self.paged_kernel = paged_kernel
        self.cache = PagedKVCache(meta["num_layers"], num_pages,
                                  page_size, kv, head_dim,
                                  device=tok.device)
        self._scratch = self.cache.alloc(page_size)[0]
        self._pool_pages = self.cache.pages_free   # after the scratch
        self.table = np.full((max_batch, self.pages_per_slot),
                             self._scratch, np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.last = np.ones((max_batch,), np.int32)
        # slot -> (request_id, prompt tokens, [tokens so far]) or None
        self.slots: list = [None] * max_batch
        self._pages: list = [None] * max_batch
        self.queue: list = []
        self._done: list = []
        self.ttft_s: dict = {}

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _need_pages(self, prompt_len: int) -> int:
        # the bucket clamps to max_prompt: every admissible request stays
        # inside pages_per_slot and the positional range
        bucket = min(self._bucket(prompt_len), self.max_prompt)
        return -(-(bucket + self.max_new + self.max_burst)
                 // self.page_size)

    def request_ids(self) -> set:
        """Ids currently queued or in flight."""
        ids = {e[0] for e in self.queue}
        ids.update(s[0] for s in self.slots if s is not None)
        return ids

    def submit(self, request_id, prompt) -> None:
        """Queue one request (a list of 1-based token ids). Raises on a
        ``request_id`` still queued or in flight, and on a request the
        pool can never hold."""
        if request_id in self.request_ids():
            raise ValueError(f"duplicate request_id {request_id!r}: "
                             "still queued or in flight")
        if len(prompt) > self.max_prompt:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds "
                             f"max_prompt {self.max_prompt}")
        if self._need_pages(len(prompt)) > self._pool_pages:
            raise ValueError(
                f"request needs {self._need_pages(len(prompt))} pages "
                f"but the pool holds {self._pool_pages} — enlarge "
                "num_pages or shorten the prompt/budget")
        self.queue.append((request_id, list(prompt), time.monotonic()))

    def cancel(self, request_id) -> bool:
        """Cancel a request: queued -> removed from the queue; in flight
        -> the slot is released and its pages freed. Nothing is reported
        through ``finished()``. Returns False for an unknown (or already
        finished) id."""
        for i, entry in enumerate(self.queue):
            if entry[0] == request_id:
                self.queue.pop(i)
                return True
        for slot, s in enumerate(self.slots):
            if s is not None and s[0] == request_id:
                self._release(slot)
                return True
        return False

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            rid, prompt, t_submit = self.queue[0]
            bucket = min(self._bucket(len(prompt)), self.max_prompt)
            pages_needed = self._need_pages(len(prompt))
            if pages_needed > self.cache.pages_free:
                break                     # admit in arrival order only
            self.queue.pop(0)
            pages = self.cache.alloc(pages_needed * self.page_size)
            self._pages[slot] = pages
            row = np.full((self.pages_per_slot,), self._scratch, np.int32)
            row[:len(pages)] = pages
            self.table[slot] = row
            # bucketed single-row prefill: the array pads to the bucket
            # width while the explicit length keeps positions/logits at
            # the true prompt end; padding columns never write pages
            padded = np.ones((1, bucket), np.int32)
            padded[0, :len(prompt)] = prompt
            first, _ = paged_prefill(
                self.model, self.cache, row[None, :], padded,
                lengths=np.asarray([len(prompt)], np.int32),
                paged_kernel=self.paged_kernel)
            tok0 = int(first[0])          # TTFT is closed by this readback
            self.ttft_s[rid] = time.monotonic() - t_submit
            self.slots[slot] = (rid, list(prompt), [tok0])
            self.lengths[slot] = len(prompt)
            self.last[slot] = tok0
            if self.eos_id is not None and tok0 == self.eos_id:
                self._retire(slot)

    def _release(self, slot: int) -> None:
        """Free a slot's pages and reset its row — no result recorded
        (shared by retire and cancel)."""
        self.cache.free(self._pages[slot])
        self._pages[slot] = None
        self.slots[slot] = None
        self.table[slot] = self._scratch
        self.lengths[slot] = 0
        self.last[slot] = 1

    def _retire(self, slot: int) -> None:
        rid, _, toks = self.slots[slot]
        if self.eos_id is not None and self.eos_id in toks:
            toks = toks[:toks.index(self.eos_id) + 1]
        self._done.append((rid, toks[:self.max_new]))
        self._release(slot)

    def _resolve_burst(self, burst: int | None) -> int:
        """``None`` -> ``min(8, max_burst)``."""
        if burst is None:
            burst = min(8, self.max_burst)
        if burst > self.max_burst:
            raise ValueError(f"burst {burst} exceeds max_burst "
                             f"{self.max_burst} (page allocations carry "
                             "max_burst-1 overshoot slack)")
        return burst

    def step(self, burst: int | None = None) -> int:
        """Admit + decode one fixed-shape burst; returns the number of
        active rows that decoded."""
        burst = self._resolve_burst(burst)
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        # free slots re-decode into the scratch page from length 0 every
        # burst, so their table gathers stay in range
        for i in range(self.max_batch):
            if self.slots[i] is None:
                self.lengths[i] = 0
        toks, new_len = paged_decode(self.model, self.cache, self.table,
                                     self.lengths, self.last, burst,
                                     paged_kernel=self.paged_kernel)
        toks = toks.cpu().numpy()
        self.lengths = new_len.cpu().numpy().astype(np.int32)
        for i in active:
            rid, prompt, got = self.slots[i]
            got.extend(int(t) for t in toks[i])
            self.last[i] = int(toks[i, -1])
            hit_eos = (self.eos_id is not None
                       and self.eos_id in got[:self.max_new])
            if hit_eos or len(got) >= self.max_new:
                self._retire(i)
        return len(active)

    def finished(self):
        """Pop (request_id, tokens) results completed so far."""
        out, self._done = self._done, []
        return out

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def run_to_completion(self, burst: int | None = None,
                          max_steps: int = 10000):
        """Drive step() until every submitted request finishes."""
        steps = 0
        while not self.idle:
            self.step(burst)
            steps += 1
            if steps > max_steps:
                raise RuntimeError("continuous batcher did not converge "
                                   f"in {max_steps} steps")
        return self.finished()

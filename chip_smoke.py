#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA
card: build every kernel from the checkout's sources, hold each against
its plain PyTorch version at the shapes the serving path gives it, then
serve requests end to end through ``ContinuousBatcher`` at the full width
of the flagship LM (d_model 1024, 12 layers, 8 heads, 2 kv heads, RoPE,
vocab 32768) with weights made from a seed.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout. It prints one line per phase, a
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises before that line
and exits non-zero; without CUDA it exits non-zero and prints no result.
It imports nothing of JAX or of ``bigdl_tpu``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the card's published peaks (H100 SXM data sheet), for the bounds
_HBM_BYTES_PER_S = 3.35e12
_BF16_FLOPS = 989e12
_FLUSH_BYTES = 256 << 20    # > 50 MB L2, and long enough to hide launches
_DEV = "cuda"

# flagship LM geometry (bench.py's transformer row, docs/PERF.md)
_LM = dict(vocab_size=32768, d_model=1024, num_heads=8, num_layers=12,
           max_len=2048, with_log_softmax=False, pos_encoding="rope",
           num_kv_heads=2)
_H, _KV, _D, _S = 8, 2, 128, 16
#: kernel vs plain: both are f32 outputs of bf16 operands; each rounds
#: the softmax weights p to bf16 (relative 2^-9) before P·V, the kernel
#: unnormalised running weights, the plain version normalised ones, and
#: sums run in another order — outputs (means of N(0, 1) values) differ
#: by about 2^-9 · max|v|. f32 pools round nothing.
_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
#: kernel vs dense serving prefill logits: both run the bf16 policy, the
#: attention outputs are rounded to bf16 before the residual add, so a
#: few elements round to the neighbouring bf16 value and the difference
#: travels through 12 blocks; bounded relative to the logits' scale
_LOGIT_REL_TOL = 0.1


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _print_ptxas(report: str) -> None:
    """Registers and spills of each paged-attention instantiation, from
    the compiler's ``-Xptxas=-v`` report (pool type, head dim, rows per
    warp)."""
    name = None
    for line in report.splitlines():
        m = re.search(r"entry function '\S*paged_attention_kernelI"
                      r"(\w+?)Li(\d+)ELi(\d+)E", line)
        if m:
            name = (f"{'bf16' if 'bfloat16' in m.group(1) else 'f32'} "
                    f"D={m.group(2)} rows/warp={m.group(3)}")
        elif name and ("registers" in line or "spill" in line):
            print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")


def _time_ms(fn, iters=20):
    """Median device time of ``fn`` over ``iters`` runs, each after an
    L2 flush (the serving path reaches every K/V page cold), from CUDA
    events around the call alone."""
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=_DEV)
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _paged_case(b, t, q_start, n_alloc, p, dtype, gen):
    """Random pools and a block table like the batcher's: row i owns
    ``n_alloc[i]`` distinct pages in random order, the rest of its ``p``
    table entries point at a scratch page (the pool's last)."""
    n_pages = int(sum(n_alloc)) + 1
    perm = torch.randperm(n_pages - 1, generator=gen).tolist()
    table = torch.full((b, p), n_pages - 1, dtype=torch.int32)
    at = 0
    for i, n in enumerate(n_alloc):
        table[i, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    shape = (n_pages, _S, _KV, _D)
    kp = torch.randn(shape, generator=gen).to(dtype)
    vp = torch.randn(shape, generator=gen).to(dtype)
    q = torch.randn((b, t, _H, _D), generator=gen).to(dtype)
    return (q.to(_DEV), kp.to(_DEV), vp.to(_DEV), table.to(_DEV),
            torch.tensor(q_start, dtype=torch.int32, device=_DEV))


def _bound(q, table, q_start, s, kv, elt):
    """Least time for this call: bytes it must move (q, the K/V pages
    each row's queries reach, table, q_start, the f32 output) over the
    memory rate vs flops over the bf16 peak."""
    b, t, h, d = q.shape
    last = q_start.long().cpu() + t - 1
    pages = torch.clamp(last // s + 1, max=table.shape[1])
    bytes_ = (q.numel() * q.element_size() + int(pages.sum()) * s * kv * d
              * elt * 2 + table.numel() * 4 + q_start.numel() * 4
              + q.numel() * 4)
    keys = sum(int(q_start[i]) * t + t * (t + 1) // 2 for i in range(b))
    flops = 4 * d * h * keys
    tb, tf = bytes_ / _HBM_BYTES_PER_S * 1e3, flops / _BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _library_ms(q, kp, vp, table, q_start, pa):
    """One PyTorch call computing the same function: SDPA on the gathered
    dense view with the causal row mask (timed here only; the port never
    calls it)."""
    import torch.nn.functional as F
    b, t, h, d = q.shape
    g = h // kp.shape[2]
    ck = pa._paged_view(kp, table).repeat_interleave(g, dim=2)
    cv = pa._paged_view(vp, table).repeat_interleave(g, dim=2)
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, ck, cv))
    kpos = torch.arange(ck.shape[1], device=q.device)
    upto = q_start.long()[:, None] + torch.arange(t, device=q.device)
    mask = (kpos[None, None, :] <= upto[:, :, None])[:, None]
    return _time_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))


def phase_kernels(pa, gen):
    """Kernel vs plain on the card at the serving path's shapes."""
    decode_len = [16, 47, 128, 300, 511, 767, 1024, 1100]
    p_slot = -(-(2048 - 64 + 64 + 8) // _S)        # the batcher's table
    cases = {
        # T=1 decode: query at position L-1 attends L keys; rows end on
        # a page boundary (16, 128, 1024) or mid-page
        "decode": _paged_case(8, 1, [n - 1 for n in decode_len],
                              [-(-n // _S) for n in decode_len], p_slot,
                              torch.bfloat16, gen),
        # prefill of a 300-token prompt in its 512-column bucket: the
        # kernel sees the whole bucket (q_start 0, T=512) and the row's
        # ceil((512 + 64 + 8) / 16) pages, as the batcher allocates them
        "prefill": _paged_case(1, 512, [0], [-(-(512 + 72) // _S)],
                               p_slot, torch.bfloat16, gen),
        "decode_f32": _paged_case(8, 1, [n - 1 for n in decode_len],
                                  [-(-n // _S) for n in decode_len],
                                  p_slot, torch.float32, gen),
    }
    results = {}
    for name, (q, kp, vp, table, qs) in cases.items():
        got = pa.paged_attention(q, kp, vp, table, qs)
        torch.cuda.synchronize()
        want = pa.paged_attention_ref(q, kp, vp, table, qs)
        err = float((got - want).abs().max())
        tol = _TOL[kp.dtype]
        if not (torch.isfinite(got).all() and err <= tol):
            raise AssertionError(f"paged_attention[{name}] max abs err "
                                 f"{err} > {tol}")
        bound, by = _bound(q, table, qs, _S, _KV, kp.element_size())
        row = dict(max_abs_err=err, tol=tol,
                   ms=_time_ms(lambda: pa.paged_attention(
                       q, kp, vp, table, qs)),
                   plain_ms=_time_ms(lambda: pa.paged_attention_ref(
                       q, kp, vp, table, qs)),
                   bound_ms=bound, bound_by=by,
                   library_ms=_library_ms(q, kp, vp, table, qs, pa))
        results[name] = row
        print(f"[kernels] paged_attention[{name}] B={q.shape[0]} "
              f"T={q.shape[1]} H={_H} KV={_KV} D={_D} S={_S} "
              f"pool={str(kp.dtype)[6:]} " + json.dumps(row), flush=True)

    # dense-cache view: a (B, M, KV, D) cache as identity-table pages of
    # dense_cache_page_size(M) = 128 slots (64 KB of K/V per page in
    # shared memory, past the 48 KB default)
    m = _LM["max_len"]
    ck = torch.randn((8, m, _KV, _D), generator=gen).to(torch.bfloat16)
    cv = torch.randn((8, m, _KV, _D), generator=gen).to(torch.bfloat16)
    q = torch.randn((8, 1, _H, _D), generator=gen).to(torch.bfloat16)
    ck, cv, q = ck.to(_DEV), cv.to(_DEV), q.to(_DEV)
    qs = torch.tensor([n - 1 for n in decode_len], dtype=torch.int32,
                      device=_DEV)
    got = pa.dense_cache_attention(q, ck, cv, qs)
    torch.cuda.synchronize()
    want = pa._attend_grouped(q, ck, cv, qs.long()[:, None], _H, _D ** -0.5)
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= _TOL[torch.bfloat16]):
        raise AssertionError(f"dense_cache_attention max abs err {err}")
    results["dense_cache"] = dict(max_abs_err=err)
    print(f"[kernels] dense_cache_attention B=8 M={m} page="
          f"{pa.dense_cache_page_size(m)} max_abs_err={err}", flush=True)
    return results


def phase_serve(pa, seed):
    """ContinuousBatcher end to end at the flagship width: 16 requests,
    prompt lengths 32..1024 from the seed, 64 new tokens each, in two
    submission waves (the second queues behind the first and is admitted
    into recycled slots and pages)."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.models.transformer.serving import (
        ContinuousBatcher, PagedKVCache, _meta_statics, _paged_prefill_impl)
    from bigdl_tpu_torch.tensor import DTypePolicy, set_policy

    # f32 params, bf16 compute, bf16 activations and KV pool (bench.py)
    set_policy(DTypePolicy(param_dtype=torch.float32,
                           compute_dtype=torch.bfloat16,
                           activation_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    model = TransformerLM(**_LM, device=_DEV,
                          generator=torch.Generator().manual_seed(seed))
    model.evaluate()
    print(f"[serve] model built in {time.perf_counter() - t0:.3f} s: "
          f"{sum(p.numel() for p in model.parameters())} params", flush=True)
    rs = np.random.default_rng(seed)
    lens = rs.integers(32, 1025, size=16)
    prompts = [rs.integers(1, _LM["vocab_size"] + 1, size=int(n)).tolist()
               for n in lens]
    new_tokens, max_batch, page = 64, 8, _S
    kw = dict(max_batch=max_batch, page_size=page,
              max_new_tokens=new_tokens, max_burst=8)
    # pages of the longest request (its bucket + budget + burst slack)
    need = -(-(ContinuousBatcher._bucket(int(lens.max())) + new_tokens
               + 8) // page)
    num_pages = max_batch * need + 1                 # + the scratch page

    # warm-up: one short request (cuBLAS handles, the kernel's library)
    warm = ContinuousBatcher(model, num_pages=num_pages, **kw)
    warm.submit("warm", prompts[0][:32])
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()

    batcher = ContinuousBatcher(model, num_pages=num_pages, **kw)
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    t0 = time.perf_counter()
    for i in range(8):
        batcher.submit(i, prompts[i])
    bursts = 0
    bursts += batcher.step() > 0
    bursts += batcher.step() > 0
    for i in range(8, 16):
        batcher.submit(i, prompts[i])
    while not batcher.idle:
        bursts += batcher.step() > 0
    results = dict(batcher.finished())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    peak = torch.cuda.max_memory_allocated()

    expect = _LM["num_layers"] * (16 + 8 * bursts)
    if launches != expect:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected 12 x (16 prefills + 8 x {bursts} "
                             f"decode steps) = {expect}")
    if sorted(results) != list(range(16)) or any(
            len(t) != new_tokens or not all(
                1 <= x <= _LM["vocab_size"] for x in t)
            for t in results.values()):
        raise AssertionError("not every request returned 64 in-vocab "
                             "tokens")
    ttft = np.asarray([batcher.ttft_s[i] for i in range(16)])
    card = _card()
    print(f"[serve] card='{card}' requests=16 prompt_lens={lens.tolist()} "
          f"new_tokens={new_tokens} decode_bursts={bursts} "
          f"kernel_launches={launches} (=12x(16+8x{bursts}))", flush=True)
    print(f"[serve] card='{card}' wall_s={wall} "
          f"generated_tok_per_s={16 * new_tokens / wall} "
          f"ttft_p50_s={np.percentile(ttft, 50)} "
          f"ttft_p99_s={np.percentile(ttft, 99)} "
          f"peak_mem_bytes={peak}", flush=True)

    # the first wave once more through the dense plain version: the
    # kernel and dense prefill logits at each prompt's last position
    wave = prompts[:8]
    width = max(batcher._bucket(len(p)) for p in wave)
    n_tab = -(-width // page)
    batch = np.ones((8, width), np.int32)
    for i, p in enumerate(wave):
        batch[i, :len(p)] = p
    lengths = np.asarray([len(p) for p in wave], np.int32)
    table = np.arange(8 * n_tab, dtype=np.int32).reshape(8, n_tab)
    logits = {}
    for mode in ("kernel", "dense"):
        cache = PagedKVCache(_LM["num_layers"], 8 * n_tab, page, _KV, _D,
                             device=_DEV)
        logits[mode] = _paged_prefill_impl(
            model.params, cache, table, batch, lengths,
            **_meta_statics(model, mode, cache.device)).float()
        del cache
    diff = float((logits["kernel"] - logits["dense"]).abs().max())
    scale = float(logits["dense"].abs().max())
    if not (torch.isfinite(logits["kernel"]).all()
            and diff <= _LOGIT_REL_TOL * scale):
        raise AssertionError(f"kernel vs dense prefill logits differ by "
                             f"{diff} > {_LOGIT_REL_TOL} x {scale}")
    first_k = logits["kernel"].argmax(-1)
    first_d = logits["dense"].argmax(-1)
    served = torch.tensor([results[i][0] - 1 for i in range(8)],
                          device=first_d.device)
    print(f"[serve] kernel vs dense prefill logits (8 prompts, bf16): "
          f"max_abs_diff={diff} max_abs_logit={scale} tol="
          f"{_LOGIT_REL_TOL}x; equal first tokens kernel/dense="
          f"{float((first_k == first_d).float().mean())} "
          f"served/dense={float((served == first_d).float().mean())}",
          flush=True)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 2
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import paged_attention as pa

    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | TF32 off for matmul and cuDNN",
          flush=True)

    t0 = time.perf_counter()
    lib = _build.load_library("paged_attention.cu")
    print(f"[build] paged_attention.cu -> {lib._name} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    _print_ptxas(Path(lib._name).with_suffix(".ptxas.txt").read_text())

    gen = torch.Generator().manual_seed(args.seed)
    rows = phase_kernels(pa, gen)
    launches = phase_serve(pa, args.seed)

    dec = rows["decode"]
    err = max(r["max_abs_err"] for r in rows.values())
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
        "replaces": "bigdl_tpu/ops/pallas/paged_attention.py:225",
        "launches": launches, "max_abs_err": err, "ms": dec["ms"],
        "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

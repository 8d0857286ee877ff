#!/usr/bin/env python3
"""Where the tensor-core paged-attention prefill kernel spends its time,
and what it is measured against: instrumented and edited copies of
``bigdl_tpu_torch/csrc/paged_attention.cu`` run at ``chip_smoke.py``'s
prefill shapes (q (1, T, 8, 128) bf16, q_start 0, pages of 16 through
the batcher's 129-entry table) and at Falcon-7B's G 71, which the
kernel folds flat (``chip_smoke._PREFILL_GEOMETRIES``' ``falcon7b-g71``
prefill, q (1, 512, 71, 64), and ``falcon7b-g71-decode``, q (4, 1, 71,
64)).

    python3 scripts/paged_prefill_timeline.py [--seed N]

Run it from the root of a checkout on the card. It prints:

- a timeline per bucket T of 512 and 1024 and per Falcon-7B case:
  thread 0 of every CTA (a
  consumer) stamps ``clock64`` at each one-off phase (page ids and
  q_start read and the ring made; Q landed; key tiles walked; output
  stored) and sums, over the CTA's key tiles, the cycles of each
  per-tile phase (tile landed; S = Q·Kᵀ; softmax; P·V); lane 0 of the
  producer warp stamps when it has issued the first tile and all of
  them; medians and largest over the CTAs, and the kernel's span on the
  global timer (steps of some 0.25 µs);
- device ms a call (CUDA events, L2 flushed, median of 20, as
  ``chip_smoke._time_ms``) at buckets 32 / 128 / 512 / 1024 and the two
  Falcon-7B cases of the kernel as built, of a copy with two warpgroups
  (128 folded rows) a CTA, and of the row-tile kernel the tensor-core
  one replaced (a copy whose route sends every bf16 call with more than
  16 rows there), in turns (built, two warpgroups, row-tile, row-tile,
  two warpgroups, built), each held against ``paged_attention_ref``
  within ``chip_smoke._PAGED_TOL``;
- the host's µs for the three tensor-map encodes of a call, and for one
  wrapper call of ``paged_attention`` (enqueue only) at T 512.

The stamps cost a few cycles each; the copies are built in a temporary
directory. The phase markers are exact lines of the source: an edit of
those lines must update ``_ONCE`` / ``_TILE`` (the script says which
moved).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import paged_attention as pa  # noqa: E402

_SLOTS = 16           # stamps a CTA: (globaltimer, clock64) each
_SUMS = 8             # the slot of the first per-tile sum
_PRELUDE = '''
__device__ unsigned long long* g_stamps;
extern "C" int set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
__device__ __forceinline__ size_t stamp_at(int i) {
  return (blockIdx.y * static_cast<size_t>(gridDim.x) + blockIdx.x) * 2 *
         16 + 2 * i;
}
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_;      \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \\
    g_stamps[stamp_at(i)] = t_; g_stamps[stamp_at(i) + 1] = clock64(); }  \\
  } while (0)
#define PSTAMP(i) do { if (threadIdx.x == kConsumers) {                  \\
    g_stamps[stamp_at(i) + 1] = clock64(); } } while (0)
#define TICK(i) do { const long long c_ = clock64();                      \\
    tl_sum[i] += c_ - tl_last; tl_last = c_; } while (0)
'''
# (phase, exact source text, stamp placed "after" or "before" it)
_ONCE = (
    ("start", "  // the row's page ids and q_start, read together, once, "
     "before any load\n", "before"),
    ("page ids read, ring made", "      make_ring<kStages>(smem_raw, "
     "Sh::L::kBars, kConsumers / 32);\n", "after"),
    ("Q landed", "    warp_wait(ring.once(), 0);\n  }\n", "after"),
    ("tiles walked", "  // f32 rows straight from the accumulator: "
     "folded row R = r0 + rl + 8r\n", "before"),
    ("stored", "            make_float2(acc[c][i] * inv, acc[c][i + 1] * "
     "inv);\n      }\n  }\n", "after"),
)
# the producer's stamps, in slots len(_ONCE) and len(_ONCE) + 1
_PRODUCER = (
    ("first tile issued", "                 c * 64, h, k % S8, page);\n"
     "      }\n", "      if (t == 0) PSTAMP(%d);\n"),
    ("all tiles issued", "    return;\n  }\n\n  // this thread's "
     "accumulator rows", "    PSTAMP(%d);\n"),
)
_TILE = (
    ("tile landed", "    warp_wait(ring.full(st), (kt / kStages) & 1);\n",
     "after"),
    ("S = Q·Kᵀ", "    wg_wait();\n    keep(s);\n", "after"),
    ("softmax", "    wg_fence();\n#pragma unroll\n    for (int kk = 0; kk < "
     "kTcKeys / 16; ++kk)\n", "before"),
    ("P·V", "    keep(pf);\n", "after"),
)
_ENCODE_BENCH = '''
#include <chrono>
extern "C" double encode_us(const void* q, const void* kp, const void* vp,
                            int B, int T, int H, int KV, int S, int NP,
                            int reps) {
  const cuuint64_t dq[4] = {128, (cuuint64_t)H, (cuuint64_t)T,
                            (cuuint64_t)B};
  const cuuint64_t dp[4] = {128, (cuuint64_t)KV, (cuuint64_t)S,
                            (cuuint64_t)NP};
  const cuuint32_t bq[4] = {64, (cuuint32_t)(H / KV),
                            (cuuint32_t)(64 / (H / KV)), 1};
  const cuuint32_t bp[4] = {64, 1, 16, 1};
  CUtensorMap m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    if (tc::make_map(&m, q, dq, bq) || tc::make_map(&m, kp, dp, bp) ||
        tc::make_map(&m, vp, dp, bp))
      return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}
'''


def _put(text, anchor, insert, where):
    if text.count(anchor) != 1:
        raise SystemExit(f"phase marker moved or repeated: {anchor!r}")
    return text.replace(anchor, anchor + insert if where == "after"
                        else insert + anchor)


def _swap(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f"source line moved or repeated: {old!r}")
    return text.replace(old, new)


def instrumented(src: str) -> str:
    """The source with a stamp at each of ``_ONCE`` and ``_PRODUCER`` and a
    per-tile sum at each of ``_TILE``, written to slots ``_SUMS``.. at
    the end."""
    n = len(_TILE)
    out = _put(src, "#include <stdint.h>\n", _PRELUDE, "after")
    for i, (_, anchor, where) in enumerate(_ONCE):
        stamp = f"  STAMP({i});\n"
        if i == 2:         # the tile sums start when Q has landed
            stamp += (f"  long long tl_sum[{n}] = {{0}};\n"
                      "  long long tl_last = clock64();\n")
        if i == 3:
            stamp = (f"  if (threadIdx.x == 0)\n    for (int i_ = 0; i_ < {n};"
                     f" ++i_) g_stamps[stamp_at({_SUMS} + i_) + 1] = "
                     "tl_sum[i_];\n" + stamp)
        out = _put(out, anchor, stamp, where)
    for i, (_, anchor, text) in enumerate(_PRODUCER):
        out = _put(out, anchor, text % (len(_ONCE) + i),
                   "before" if "return" in anchor else "after")
    for i, (_, anchor, where) in enumerate(_TILE):
        out = _put(out, anchor, f"    TICK({i});\n", where)
    return out


def _call(fn, q, kp, vp, table, qs, out):
    """The C entry on a bf16 prefill call (no split: no workspace), as
    the wrapper makes it; returns the route it took."""
    route = ctypes.c_int(-1)
    b, t, h, d = q.shape
    err = fn(1, q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
             qs.data_ptr(), out.data_ptr(), None, None, ctypes.byref(route),
             b, t, h, kp.shape[2], d, kp.shape[1], table.shape[1],
             kp.shape[0], 0, d ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed (code {err})")
    return route.value


def _timeline(fn, lib, args, label):
    q, kv = args[0], args[1].shape[2]
    g = q.shape[2] // kv
    fold = g if g > pa._TC_ROWS else 1 << (g - 1).bit_length()
    n_ctas = q.shape[0] * kv * -(-q.shape[1] * fold // 64)
    stamps = torch.zeros(n_ctas * _SLOTS * 2, dtype=torch.int64,
                         device="cuda")
    if lib.set_stamps(stamps.data_ptr()):
        raise RuntimeError("set_stamps failed")
    out = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    flush = torch.empty(cs._FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(5):                     # the last run is reported
        stamps.zero_()
        flush.zero_()
        _call(fn, *args, out)
        torch.cuda.synchronize()
    t = stamps.view(n_ctas, _SLOTS, 2).cpu().numpy().astype(np.float64)
    t0 = t[:, 0, 0].min()
    span = (t[:, len(_ONCE) - 1, 0].max() - t0) / 1e3
    print(f"{label}: {n_ctas} CTAs; span {span:.3f} µs (first start to "
          f"last store, global timer)")
    for i in range(1, len(_ONCE)):
        d = t[:, i, 1] - t[:, i - 1, 1]
        print(f"  {_ONCE[i - 1][0]:>24} -> {_ONCE[i][0]:<24} cycles median "
              f"{np.median(d):8.0f}  max {d.max():8.0f}")
        if i == 3:
            for j, (name, _, _) in enumerate(_TILE):
                s = t[:, _SUMS + j, 1]
                print(f"  {'':>8}sum over tiles: {name:<16} cycles median "
                      f"{np.median(s):8.0f}  max {s.max():8.0f}")
    for j, (name, _, _) in enumerate(_PRODUCER):
        d = t[:, len(_ONCE) + j, 1] - t[:, 1, 1]
        print(f"  producer: {_ONCE[1][0]} -> {name:<18} cycles median "
              f"{np.median(d):8.0f}  max {d.max():8.0f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_prefill_timeline: needs the card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build._CSRC / "paged_attention.cu").read_text()
    copies = {
        "built": src + _ENCODE_BENCH,
        "two warpgroups": _swap(src, "constexpr int kTcWarpgroups = 1;",
                                "constexpr int kTcWarpgroups = 2;"),
        "row-tile": _swap(src, "  if (dtype == 1 && P <= tc::kTcMaxPages)",
                          "  if (false && P <= tc::kTcMaxPages)"),
        "timeline": instrumented(src)}
    gen = torch.Generator().manual_seed(args.seed)
    cases = {f"T={t}": cs._paged_case(1, t, [0], [-(-(t + 72) // cs._S)],
                                      129, torch.bfloat16, gen)
             for t in cs._PREFILL_BUCKETS}
    for label, b, t, h, kv, d, s, p, dtype, starts, _ in \
            cs._PREFILL_GEOMETRIES:
        if label.startswith("falcon7b-g71"):
            cases[label] = cs._paged_case(
                b, t, starts, [min(p, (x + t) // s + 1) for x in starts], p,
                dtype, gen, h=h, kv=kv, d=d, s=s)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(copies) + 1) as pool:   # one nvcc each
            wrapper = pool.submit(pa._kernel_fn)
            built = {k: pool.submit(_build.build_copy, text,
                                    tmp / k.replace(" ", "_"))
                     for k, text in copies.items()}
            libs = {k: f.result() for k, f in built.items()}
            wrapper.result()
        print(f"built {len(copies) + 1} copies in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        fns = {k: pa._bind(lib) for k, lib in libs.items()}
        libs["timeline"].set_stamps.argtypes = [ctypes.c_void_p]
        cs._warm_card()
        for label in ("T=512", "T=1024", "falcon7b-g71",
                      "falcon7b-g71-decode"):
            _timeline(fns["timeline"], libs["timeline"], cases[label],
                      f"{label} bf16")
        order = ("built", "two warpgroups", "row-tile", "row-tile",
                 "two warpgroups", "built")
        want_route = {"built": 1, "two warpgroups": 1, "row-tile": 2}
        for t, case in cases.items():
            ref = pa.paged_attention_ref(*case)
            ms = {}
            for name in order:
                out = torch.empty(case[0].shape, dtype=torch.float32,
                                  device="cuda")
                if _call(fns[name], *case, out) != want_route[name]:
                    raise AssertionError(f"{name} took another route")
                torch.cuda.synchronize()
                cs._paged_check(f"{name} {t}", out, ref,
                                cs._PAGED_TOL[torch.bfloat16])
                ms.setdefault(name, []).append(cs._time_ms(
                    lambda f=fns[name], o=out: _call(f, *case, o)))
            print(f"{t} device ms a call (in turns): " + ", ".join(
                f"{k} {v}" for k, v in ms.items()), flush=True)
        q, kp, vp, table, qs = cases["T=512"]
        enc = libs["built"].encode_us
        enc.restype = ctypes.c_double
        enc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
        us = enc(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), 1, 512, 8, 2,
                 16, kp.shape[0], 1000)
        calls = 200
        pa.paged_attention(q, kp, vp, table, qs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            pa.paged_attention(q, kp, vp, table, qs)
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        print(f"host: three tensor-map encodes {us:.3f} µs a call; one "
              f"paged_attention wrapper call at T=512 {host:.3f} µs "
              f"(enqueue, mean of {calls})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

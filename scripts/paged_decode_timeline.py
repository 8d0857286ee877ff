#!/usr/bin/env python3
"""Where the split-KV paged-attention decode kernel spends its time: an
instrumented copy of ``bigdl_tpu_torch/csrc/paged_attention.cu`` in which
thread 0 of every CTA stamps ``clock64`` and ``%globaltimer`` at each
phase boundary, run at ``chip_smoke.py``'s serving decode shapes.

    python3 scripts/paged_decode_timeline.py [--seed N] \
        [--pages-per-split P ...]

Run it from the root of a checkout on the card. For each case and split
width it prints the median and the largest cycles of each phase over the
live CTAs (q_start, page ids and q read; K/V copies issued; landed;
scored; softmax; P·V; partials written; counted; merged, the last only
in the CTA that merges), and the kernel's span from the first CTA's
start to the last merge on the global timer (which ticks in steps of
some 0.25 µs). The stamps cost a few cycles each; the copy is built in a
temporary directory. The phase markers are exact lines of the source: an
edit of those lines must update ``_PHASES`` (the script says which moved).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import paged_attention as pa  # noqa: E402

_STAMPS = 16          # slots a CTA: (globaltimer, clock64) each
_DEAD = 15            # the slot of a CTA that exits at once
_PRELUDE = '''
__device__ unsigned long long* g_stamps;
extern "C" int set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_;      \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \\
    const size_t o_ = (blockIdx.y * static_cast<size_t>(gridDim.x) +       \\
                       blockIdx.x) * 2 * 16 + 2 * (i);                      \\
    g_stamps[o_] = t_; g_stamps[o_ + 1] = clock64(); } } while (0)
'''
# (phase name, exact source text, stamp placed "after" or "before" it)
_PHASES = (
    ("start", "  const SplitSmem lay =\n      split_smem(ROWS,", "before"),
    ("read q_start, pages, q", "  __syncthreads();                    "
     "          // pages\n", "after"),
    ("issued", "  load_chunk(0, 0);\n  cp_async_commit();\n", "after"),
    ("landed", "    cp_async_wait_prev();                        // chunk c "
     "has landed\n    __syncthreads();\n", "after"),
    ("scored", "    // online softmax, once a chunk: one warp per query "
     "row\n", "before"),
    ("softmax", "    // P·V: one V vector read feeds every query row\n",
     "before"),
    ("P·V", "  // sum the slices' partials: lanes that share a slice, then "
     "groups\n", "before"),
    ("partials written", "  // the last live split of (b, h) to get here "
     "merges", "before"),
    ("counted", "  if (!*last_flag) return;\n", "after"),
    ("merged", "      if (!PAD || lane + 32 * i < Dt) dst[lane + 32 * i] = "
     "o[i] / l_all;\n  }\n", "after"),
)
_EXIT = ("  if (k_begin > last) {                         // split wholly "
         "past the row\n")
_FIRST_CHUNK = ("landed", "scored", "softmax")


def instrumented(src: str) -> str:
    """The kernel source with a stamp at each of ``_PHASES``."""
    def put(text, anchor, stamp, where):
        if text.count(anchor) != 1:
            raise SystemExit(f"phase marker moved or repeated: {anchor!r}")
        return text.replace(anchor, anchor + stamp if where == "after"
                            else stamp + anchor)
    out = put(src, "#include <stdint.h>\n", _PRELUDE, "after")
    for i, (name, anchor, where) in enumerate(_PHASES):
        stamp = f"  STAMP({i});\n"
        if name in _FIRST_CHUNK:
            stamp = f"    if (c == 0) STAMP({i});\n"
        out = put(out, anchor, stamp, where)
    return put(out, _EXIT, f"    STAMP({_DEAD});\n", "after")


def _bind(lib):
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    return pa._bind(lib)


def report(label, stamps, n_ctas):
    t = stamps.view(-1, _STAMPS, 2).cpu().numpy()[:n_ctas].astype(np.float64)
    started = t[:, 0, 0] > 0
    live = started & (t[:, _DEAD, 0] == 0)
    t0 = t[started, 0, 0].min()
    merged = t[:, len(_PHASES) - 1, 0] > 0
    print(f"{label}: {int(live.sum())} live CTAs of {n_ctas}; span "
          f"{(t[merged, len(_PHASES) - 1, 0].max() - t0) / 1e3:.3f} µs "
          f"(first start to last merge, global timer)")
    for i in range(1, len(_PHASES)):
        sel = live & (t[:, i, 1] > 0) & (t[:, i - 1, 1] > 0)
        d = t[sel, i, 1] - t[sel, i - 1, 1]
        print(f"  {_PHASES[i - 1][0]:>24} -> {_PHASES[i][0]:<22} cycles "
              f"median {np.median(d):8.0f}  max {d.max():8.0f}  "
              f"({int(sel.sum())} CTAs)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pages-per-split", type=int, nargs="*", default=[],
                    help="split widths to stamp besides the one "
                         "decode_split_pages picks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_decode_timeline: needs the card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    src = (_build._CSRC / "paged_attention.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build.build_copy(instrumented(src), Path(tmp) / "timeline")
        fn = _bind(lib)
        gen = torch.Generator().manual_seed(args.seed)
        p_slot = -(-(2048 - 64 + 64 + 8) // cs._S)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chosen = pa.decode_split_pages(8, cs._KV, p_slot, sms)
        widths = [chosen] + [w for w in args.pages_per_split if w != chosen]
        cases = (("decode", [16, 47, 128, 300, 511, 767, 1024, 1100]),
                 ("decode_long",
                  np.linspace(1985, 2048, 8).round().astype(int).tolist()))
        pa._kernel_fn.cache_clear()
        kernel_fn, split_pages = pa._kernel_fn, pa.decode_split_pages
        pa._kernel_fn = lambda: fn
        flush = torch.empty(cs._FLUSH_BYTES, dtype=torch.uint8,
                            device="cuda")
        try:
            for (label, lens), pps in ((c, w) for c in cases
                                       for w in widths):
                pa.decode_split_pages = lambda *_, n=pps: n
                n_ctas = 8 * cs._KV * -(-p_slot // pps)
                stamps = torch.zeros(n_ctas * _STAMPS * 2, dtype=torch.int64,
                                     device="cuda")
                if lib.set_stamps(stamps.data_ptr()):
                    raise RuntimeError("set_stamps failed")
                args_ = cs._paged_case(8, 1, [n - 1 for n in lens],
                                       [-(-n // cs._S) for n in lens],
                                       p_slot, torch.bfloat16, gen)
                for _ in range(5):             # the last run is reported
                    stamps.zero_()
                    flush.zero_()
                    pa.paged_attention(*args_)
                    torch.cuda.synchronize()
                report(f"{label} bf16, {pps} pages a split", stamps, n_ctas)
        finally:
            pa._kernel_fn, pa.decode_split_pages = kernel_fn, split_pages
    return 0


if __name__ == "__main__":
    sys.exit(main())

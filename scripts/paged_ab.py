#!/usr/bin/env python3
"""Time two versions of the paged-attention kernels in turns on one
NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/paged_attention.cu`` of this checkout and
the one under ``--other`` (a directory holding a ``paged_attention.cu``,
such as another checkout's ``bigdl_tpu_torch/csrc``; both built with
this checkout's headers) into a temporary directory and runs each
version's C entry through this checkout's wrapper on each route at
``chip_smoke.py``'s shapes: the split-KV decode (its ``[kernels]``
decode case: 8 rows of 16..1100 keys, pages of 16, the batcher's
129-entry table), the tensor-core prefill (the T 512 bucket) and the
row-tile prefill at the geometries of ``chip_smoke._PREFILL_GEOMETRIES``
that take it with one chunk a page (an f32 pool, pages of 7, f32 at D
192, pages of 12 at D 192). For each case it prints whether the two
versions' outputs are bit-equal and each version's worst error over
``chip_smoke._PAGED_TOL`` against the plain version, then times the
calls in turns (this, other, other, this; ``chip_smoke._time_ms`` each:
L2 flushed, median of 20): one line per case with both versions' times
and the ratio of their means (this / other). Last, the card's name and
power limit. It exits 1 if any output of either version is non-finite
or past its limit, after every case has been checked and timed.

    python3 scripts/paged_ab.py --other DIR [--seed N]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import paged_attention as pa  # noqa: E402

_ORDER = ("this", "other", "other", "this")
#: the row-tile geometries of ``chip_smoke._PREFILL_GEOMETRIES``
_ROW_CASES = ("f32-pools", "s7", "d192-f32", "d192-s12")


def _cases(gen):
    """(label, route, (q, kp, vp, table, q_start)) at chip_smoke's
    shapes."""
    decode_len = [16, 47, 128, 300, 511, 767, 1024, 1100]
    p_slot = -(-(2048 - 64 + 64 + 8) // cs._S)
    out = [("decode", "split", cs._paged_case(
                8, 1, [n - 1 for n in decode_len],
                [-(-n // cs._S) for n in decode_len], p_slot,
                torch.bfloat16, gen)),
           ("prefill T=512", "tc", cs._paged_case(
                1, 512, [0], [-(-(512 + 72) // cs._S)], p_slot,
                torch.bfloat16, gen))]
    for label, b, t, h, kv, d, s, p, dtype, starts, route in \
            cs._PREFILL_GEOMETRIES:
        if label in _ROW_CASES:
            out.append((label, route, cs._paged_case(
                b, t, starts, [min(p, (x + t) // s + 1) for x in starts],
                p, dtype, gen, h=h, kv=kv, d=d, s=s)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other paged_attention.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_ab: CUDA is not available", file=sys.stderr)
        return 2
    sources = {"this": (ROOT / "bigdl_tpu_torch/csrc/paged_attention.cu")
               .read_text(),
               "other": (Path(args.other) / "paged_attention.cu")
               .read_text()}
    card = cs._card()
    chosen = pa._kernel_fn
    past = []
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            fns = dict(zip(sources, pool.map(
                lambda kv: pa._bind(_build.build_copy(kv[1],
                                                      Path(tmp) / kv[0])),
                sources.items())))
        cs._warm_card()
        try:
            for label, route, case in _cases(
                    torch.Generator().manual_seed(args.seed)):
                past += _ab(fns, label, route, case, card)
        finally:
            pa._kernel_fn = chosen
    if past:
        print("[ab] past the limit (or non-finite): " + "; ".join(past),
              flush=True)
    print(card)
    return 1 if past else 0


def _ab(fns, label, route, case, card):
    """One case: both versions checked, then timed in turns; returns the
    versions whose output is non-finite or past its limit."""
    want = pa.paged_attention_ref(*case)
    tol = cs._PAGED_TOL[case[1].dtype]
    outs, worst, past = {}, {}, []
    for version, fn in fns.items():
        pa._kernel_fn = lambda f=fn: f
        outs[version] = cs._paged_call(pa, f"{version} {label}", route,
                                       *case)
        worst[version] = cs._worst(outs[version], want, *tol,
                                   rms_dims=(2, 3))[1]
        if not (worst[version] <= 1 and torch.isfinite(
                outs[version]).all()):
            past.append(f"{version} {label} ({worst[version]})")
    times = {"this": [], "other": []}
    for version in _ORDER:
        pa._kernel_fn = lambda f=fns[version]: f
        times[version].append(cs._time_ms(lambda: pa.paged_attention(*case)))
    row = dict(route=route, bit_equal=torch.equal(outs["this"],
                                                  outs["other"]),
               worst_error_over_limit=worst, this_ms=times["this"],
               other_ms=times["other"],
               ratio=float(np.mean(times["this"])
                           / np.mean(times["other"])))
    print(f"[ab] paged_attention {label} pool={str(case[1].dtype)[6:]} "
          f"card='{card}' " + json.dumps(row), flush=True)
    return past


if __name__ == "__main__":
    sys.exit(main())

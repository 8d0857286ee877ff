#!/usr/bin/env python3
"""Time two versions of the paged-attention kernels in turns on one
NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/paged_attention.cu`` of this checkout and
the one under ``--other`` (a directory holding a ``paged_attention.cu``,
such as another checkout's ``bigdl_tpu_torch/csrc``; both built with
this checkout's headers) into a temporary directory and runs each
version's C entry through this checkout's wrapper at ``chip_smoke.py``'s
shapes: the split-KV decode (its ``[kernels]`` decode case: 8 rows of
16..1100 keys, pages of 16, the batcher's 129-entry table), the
tensor-core prefill at the T 512 bucket, and every row of
``chip_smoke._DECODE_GEOMETRIES`` (the split-KV kernel's other
instantiations), ``_PREFILL_GEOMETRIES`` (head dims 32-256, G 1-64
padded to a power of two, pages of 7-300 slots, chunked rows, f32 pools,
and the groups past G 64 that the tensor-core kernel folds flat:
Falcon-7B's G 71 prefill and decode, G 65, 96 and 128) and
``_POOL_GEOMETRIES`` (pages of 256 and 300 slots, a 4097-entry table,
head dims 320 to 2048 on the row-tile kernel's wide and sliced forms,
prefill and decode, bf16 and f32).

With ``--sliced`` instead of ``--other``, the other version is this
checkout's source with every head dim past 256 routed to the row-tile
kernel's column-sliced form (``SLICED_EVERYWHERE``: exact text
replacements, exit 1 if one is not found), and only the cases past D
256 run: the sliced form against the wide kernel at the head dims the
wide kernel takes. With ``--fold``, the other version is this source
with the tensor-core route refused past G 64 (``ROW_PAST_G64``), so
those calls take the row-tile kernel, and only the cases past G 64 run:
the flat fold against the row-tile kernel, in turns.

The two versions may take different routes on a case. Each C entry is
run through ``paged_attention._launch`` (the wrapper's launch, after
its checks) and reports the route it took: this checkout's is held to
its ``kernel_route``, the other's is printed as it reported it. For each
case it prints both routes, whether the two outputs are bit-equal and
each version's worst error over
``chip_smoke._PAGED_TOL`` against the plain version, then times the
calls in turns (this, other, other, this; ``chip_smoke._time_ms`` each:
L2 flushed, median of 20): one line per case with both versions' times
and the ratio of their means (this / other). A case the other version
refuses (a head dim it was not built for: its entry's error) is checked
and timed for this version alone, and counted as refused. Then a
summary of the cases both versions ran on one route (how many are
bit-equal, the range of their ratios), each version's registers and
spills of the tensor-core prefill kernel at D 64, 128 and 256 and of
the split-KV kernel at D 128 (from ptxas), and the card's name and
power limit. It exits 1 if any output of either version is non-finite
or past its limit, or this checkout's route is not its
``kernel_route``, after every case has been checked and timed.

    python3 scripts/paged_ab.py (--other DIR | --sliced | --fold) [--seed N]
"""
from __future__ import annotations

import argparse
import json
import re
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
#: (text of paged_attention.cu, its replacement) that route every head
#: dim past 256 to the column-sliced row-tile kernel
SLICED_EVERYWHERE = (
    ("    return D > wide_max_d(elt) ? kRouteRowSliced : kRouteRow;",
     "    return kRouteRowSliced;"),
    ("  if (D % 64 != 0 || D <= wide_max_d(sizeof(T))) return -1;",
     "  if (D % 64 != 0) return -1;"))
#: (text of paged_attention.cu, its replacement) that refuse the
#: tensor-core route past G 64, the parent's route for those calls
ROW_PAST_G64 = (
    ("  if (dtype == 1 && P <= tc::kTcMaxPages) return kRouteTc;",
     "  if (dtype == 1 && G <= tc::kWgRows && P <= tc::kTcMaxPages)\n"
     "    return kRouteTc;"),)


def _cases(gen):
    """(label, (q, kp, vp, table, q_start)) at chip_smoke's shapes."""
    decode_len = [16, 47, 128, 300, 511, 767, 1024, 1100]
    p_slot = -(-(2048 - 64 + 64 + 8) // cs._S)
    out = [("decode", cs._paged_case(
                8, 1, [n - 1 for n in decode_len],
                [-(-n // cs._S) for n in decode_len], p_slot,
                torch.bfloat16, gen)),
           ("prefill T=512", cs._paged_case(
                1, 512, [0], [-(-(512 + 72) // cs._S)], p_slot,
                torch.bfloat16, gen))]
    rows = [(f"decode {r[0]}", *r[1:9],
             [x - r[2] + 1 if x >= r[2] - 1 else 0 for x in r[9]], None)
            for r in cs._DECODE_GEOMETRIES]
    for label, b, t, h, kv, d, s, p, dtype, starts, _ in \
            rows + list(cs._PREFILL_GEOMETRIES + cs._POOL_GEOMETRIES):
        out.append((label, cs._paged_case(
            b, t, starts, [min(p, (x + t) // s + 1) for x in starts], p,
            dtype, gen, h=h, kv=kv, d=d, s=s)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    other = ap.add_mutually_exclusive_group(required=True)
    other.add_argument("--other",
                       help="directory holding the other paged_attention.cu")
    other.add_argument("--sliced", action="store_true",
                       help="the other version: this source with every D "
                            "past 256 on the column-sliced form")
    other.add_argument("--fold", action="store_true",
                       help="the other version: this source with every G "
                            "past 64 on the row-tile kernel")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_ab: CUDA is not available", file=sys.stderr)
        return 2
    this = (ROOT / "bigdl_tpu_torch/csrc/paged_attention.cu").read_text()
    past = []
    if args.sliced or args.fold:
        theirs = this
        for old, new in SLICED_EVERYWHERE if args.sliced else ROW_PAST_G64:
            if theirs.count(old) != 1:
                past.append(f"replacement text not found: {old.strip()!r}")
            theirs = theirs.replace(old, new)
    else:
        theirs = (Path(args.other) / "paged_attention.cu").read_text()
    sources = {"this": this, "other": theirs}
    card = cs._card()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            fns = dict(zip(sources, pool.map(
                lambda kv: pa._bind(_build.build_copy(kv[1],
                                                      Path(tmp) / kv[0])),
                sources.items())))
        regs = {v: _registers((Path(tmp) / v).with_suffix(".ptxas.txt")
                              .read_text()) for v in sources}
        cs._warm_card()
        same, refused = [], []
        for label, case in _cases(torch.Generator().manual_seed(args.seed)):
            g = case[0].shape[2] // case[1].shape[2]
            if ((not args.sliced or case[0].shape[-1] > 256)
                    and (not args.fold or g > 64)):
                row, bad = _ab(fns, label, case, card)
                past += bad
                if row["routes"]["other"] is None:
                    refused.append(label)
                elif row["routes"]["this"] == row["routes"]["other"]:
                    same.append(row)
    if same:
        ratios = [r["ratio"] for r in same]
        print(f"[ab] {len(same)} cases on one route in both versions: "
              f"{sum(r['bit_equal'] for r in same)} bit-equal, this / "
              f"other {min(ratios):.4f}-{max(ratios):.4f}", flush=True)
    if refused:
        print(f"[ab] {len(refused)} cases the other version refuses, run "
              f"by this one alone: {', '.join(refused)}", flush=True)
    print("[ab] ptxas registers (spill stores) by version: "
          + json.dumps(regs), flush=True)
    if past:
        print("[ab] past the limit, non-finite or off its route: "
              + "; ".join(past), flush=True)
    print(card)
    return 1 if past else 0


def _registers(report):
    """{kernel: "registers (spill store bytes)"} of the tensor-core
    prefill kernel at D 64, 128 and 256 and the bf16 split-KV kernel at
    D 128 (both row counts), from a ``-Xptxas=-v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        t = re.search(r"entry function '\S*?paged_prefill_tc_kernelILi(\d+)E",
                      line)
        sp = re.search(r"entry function '\S*?paged_decode_split_kernelI"
                       r"(\w+?)Li(\d+)ELi(\d+)E(?:Lb([01])E)?", line)
        if "entry function" in line:
            # the split kernel's instantiation at a built head dim (not
            # its PAD one)
            name = (f"tc D={t.group(1)}" if t and t.group(1) in (
                "64", "128", "256") else
                f"split bf16 D=128 rows<={sp.group(3)}" if sp and
                "bfloat16" in sp.group(1) and sp.group(2) == "128"
                and sp.group(4) != "1" else None)
        elif name:
            spill = re.search(r"(\d+) bytes spill stores", line)
            used = re.search(r"Used (\d+) registers", line)
            if spill:
                out[name] = f"({spill.group(1)})"
            if used:
                out[name] = f"{used.group(1)} {out.get(name, '')}".strip()
    return out


def _ab(fns, label, case, card):
    """One case: both versions checked, then timed in turns; returns its
    row and the versions whose output is non-finite or past its limit,
    or whose route (this checkout's) is not the one ``kernel_route``
    names. Where the other version refuses the case (its entry returns
    an error), this version alone is checked and timed, the other's
    route None."""
    want = pa.paged_attention_ref(*case)
    q, kp = case[0], case[1]
    _, t, h, d = q.shape
    route = pa.kernel_route(t, h, kp.shape[2], d, kp.shape[1],
                            case[3].shape[1], kp.dtype)
    tol = cs._PAGED_TOL[kp.dtype]
    scale = d ** -0.5
    outs, worst, routes, past = {}, {}, {}, []
    calls = {v: (lambda f=fn: pa._launch(f, *case, scale, route))
             for v, fn in fns.items()}
    for version, call in list(calls.items()):
        try:
            outs[version], routes[version] = call()
        except RuntimeError as e:
            if version == "this":
                raise
            print(f"[ab] paged_attention {label}: the other version "
                  f"refuses it ({e})", flush=True)
            routes[version] = None
            del calls[version]
            continue
        torch.cuda.synchronize()
        if version == "this" and routes[version] != route:
            past.append(f"this {label} took {routes[version]}, "
                        f"kernel_route names {route}")
        worst[version] = cs._worst(outs[version], want, *tol,
                                   rms_dims=(2, 3))[1]
        if not (worst[version] <= 1 and torch.isfinite(
                outs[version]).all()):
            past.append(f"{version} {label} ({worst[version]})")
    times = {"this": [], "other": []}
    for version in _ORDER:
        if version in calls:
            times[version].append(cs._time_ms(calls[version]))
    both = "other" in calls
    row = dict(routes=routes,
               bit_equal=both and torch.equal(outs["this"], outs["other"]),
               worst_error_over_limit=worst, this_ms=times["this"],
               other_ms=times["other"],
               ratio=float(np.mean(times["this"])
                           / np.mean(times["other"])) if both else None)
    print(f"[ab] paged_attention {label} pool={str(case[1].dtype)[6:]} "
          f"card='{card}' " + json.dumps(row), flush=True)
    return row, past


if __name__ == "__main__":
    sys.exit(main())

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
head dims 320 to 2048, prefill on the sliced tensor-core kernel (bf16)
and the row-tile kernel's wide and sliced forms (f32), decode on the
row-tile kernels). ``--past-256`` keeps only the cases past head dim
256.

With ``--sliced`` instead of ``--other``, the other version is this
checkout's source with every head dim past 256 routed to the row-tile
kernel's column-sliced form (``SLICED_EVERYWHERE``: exact text
replacements, exit 1 if one is not found), and only the cases past D
256 run: the sliced form against the wide kernel at the head dims the
wide kernel takes. With ``--fold``, the other version is this source
with the tensor-core route refused past G 64 (``ROW_PAST_G64``), so
those calls take the row-tile kernel, and only the cases past G 64 run:
the flat fold against the row-tile kernel, in turns. With
``--tc-sliced``, the other version is this source with decode past head
dim 256 (T·G <= 16) sent back to the row-tile kernels (``ROW_DECODE``),
and only the bf16 decode cases past D 256 run: the sliced tensor-core
kernel, which this source routes them to, against the row-tile kernels,
in turns (the timing that decided that route). With
``--two-warpgroups``, the other version is this source with two
consumer warpgroups a CTA of the sliced tensor-core kernel (128 folded
query rows sharing each K chunk, half the CTAs; a producer warpgroup
whose ``setmaxnreg`` hands the consumers 232 registers, as one
warpgroup's CTA of 192 threads has without it; ``TWO_WARPGROUPS``), and
only the cases that kernel takes run.

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
spills of the tensor-core prefill kernel at D 64, 128 and 256, of its
sliced form (3 and 4 chunks a slice) and of the split-KV kernel at D
128 (from ptxas), and the card's name and
power limit. It exits 1 if any output of either version is non-finite
or past its limit, or this checkout's route is not its
``kernel_route``, after every case has been checked and timed.

With ``--fit OUTPUT`` it needs no card: it reads a saved output of this
script and fits this version's times of the sliced tensor-core cases
(``_POOL_GEOMETRIES`` rows) against the serial (key tile, chunk) steps
of each case's CTA with the most keys, printing the fixed and per-step
microseconds and each case's deviation.

    python3 scripts/paged_ab.py (--other DIR | --sliced | --fold |
        --tc-sliced | --two-warpgroups | --no-k-loads | --one-box)
        [--past-256] [--seed N]
    python3 scripts/paged_ab.py --fit OUTPUT
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
#: (text of paged_attention.cu, its replacement) that send decode past
#: head dim 256 (T·G <= 16 rows a kv head) back to the row-tile kernels
ROW_DECODE = (
    ("    if (takes_tc_sliced(dtype, G, Dt, P)) return kRouteTcSliced;",
     "    if (T * G > kSplitRows && takes_tc_sliced(dtype, G, Dt, P))\n"
     "      return kRouteTcSliced;"),)
#: (text of paged_attention.cu, its replacement) that give a CTA of the
#: sliced tensor-core kernel two consumer warpgroups of 64 folded rows
#: each, sharing every K chunk, and a producer warpgroup (setmaxnreg 40 /
#: 232: 384 threads hold 168 registers each at launch, and the
#: consumers need some 205); Q comes as a box a warpgroup
TWO_WARPGROUPS = (
    ("constexpr int kSlConsumers = 128;",
     "constexpr int kSlConsumers = 256;"),
    ("constexpr int kSlRows = kWgRows;",
     "constexpr int kSlRows = 2 * kWgRows;"),
    ("constexpr int kSlThreads = kSlConsumers + 64;",
     "constexpr int kSlThreads = kSlConsumers + 128;"),
    ("  if (tid >= kSlConsumers) {\n",
     "  if (tid >= kSlConsumers) {\n    regs_dec<40>();\n"),
    ("    } else {\n      // each key tile's V slice",
     "    } else if (tid < kSlConsumers + 64) {\n      // each key tile's V "
     "slice"),
    ("          if (q_now) tma_load(qdst, &qm, full(st), 64 * c, h * G, t0, "
     "b);\n",
     "          for (int w = 0; q_now && w < 2; ++w)\n"
     "            tma_load(qdst + w * kChunk, &qm, full(st), 64 * c, h * G,\n"
     "                     t0 + w * (kWgRows / F), b);\n"),
    # the warpgroup index broadcast from lane 0, so ptxas sees branches
    # on it as uniform and does not serialise wgmma (C7518)
    ("  const int rl = 16 * (tid / 32) + l / 4;\n",
     "  regs_inc<232>();\n"
     "  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);\n"
     "  const int rl = kWgRows * g + 16 * (tid / 32 % 4) + l / 4;\n"),
    ("  const int first_wg = qs + r0 / F;\n",
     "  const int first_wg = qs + (r0 + kWgRows * g) / F;\n"),
    ("desc_k<kSlRows>(qc, 0, kk)", "desc_k<kSlRows>(qc, kWgRows * g, kk)"),
)
#: (text of paged_attention.cu, its replacement) that leave out every K
#: load of the sliced tensor-core kernel: the K producer arrives on each
#: stage with Q's bytes alone (none where Q is resident), the products
#: read whatever the stage holds. Timing only: its outputs are not held
NO_K_LOADS = (
    ("          bar_expect(full(st), kChunk + (q_now ? kQChunk : 0));",
     "          bar_expect(full(st), q_now ? kQChunk : 0);"),
    ("        for (int e = l; e < nbox; e += 32) {\n"
     "          const int k = k0 + e * br;\n",
     "        for (int e = l; e < 0 * nbox; e += 32) {\n"
     "          const int k = k0 + e * br;\n"),
)
#: (text of paged_attention.cu, its replacement) that load each 64-key
#: K chunk and V chunk of the sliced tensor-core kernel as one box of 64
#: slots instead of 64 / br boxes of a page's br slots: the pools mapped
#: as (Dt, KV, S·NP, 1), the box at the tile's first page id taking the
#: slots that follow it in memory (the next pages of the pool, not the
#: table's). A quarter of the TMA issues at pages of 16; timing only:
#: its outputs are not held
ONE_BOX = (
    ("        for (int e = l; e < nbox; e += 32) {\n"
     "          const int k = k0 + e * br;\n"
     "          tma_load(dst + e * br * kRowBytes, &km, full(st), 64 * c, h,\n"
     "                   k % S8, k < kend ? pages[k / S8] : -1);\n"
     "        }\n",
     "        if (l == 0)\n"
     "          tma_load(dst, &km, full(st), 64 * c, h,\n"
     "                   k0 < kend ? pages[k0 / S8] * S + k0 % S8 : -64, "
     "0);\n"),
    ("        for (int e = l; e < OWN * nbox; e += 32) {\n"
     "          const int j = e / nbox, k = kt * kTcKeys + e % nbox * br;\n"
     "          tma_load(vb + j * kChunk + e % nbox * br * kRowBytes, &vm, "
     "vfull,\n"
     "                   col0 + 64 * j, h, k % S8, k < kend ? pages[k / S8] "
     ": -1);\n"
     "        }\n",
     "        for (int j = l; j < OWN; j += 32) {\n"
     "          const int k = kt * kTcKeys;\n"
     "          tma_load(vb + j * kChunk, &vm, vfull, col0 + 64 * j, h,\n"
     "                   k < kend ? pages[k / S8] * S + k % S8 : -64, 0);\n"
     "        }\n"),
    ("  if (int e = make_maps(a, kWgRows, &qm, &km, &vm)) return e;\n"
     "  if (sl_own(a.D / 64) == 3)",
     "  if (int e = make_maps(a, kWgRows, &qm, &km, &vm)) return e;\n"
     "  const cuuint64_t flat[4] = {static_cast<cuuint64_t>(a.Dt),\n"
     "                              static_cast<cuuint64_t>(a.KV),\n"
     "                              static_cast<cuuint64_t>(a.S) * a.NP, 1};\n"
     "  const cuuint32_t box[4] = {64, 1, 64, 1};\n"
     "  if (int e = make_map(&km, a.kp, flat, box)) return e;\n"
     "  if (int e = make_map(&vm, a.vp, flat, box)) return e;\n"
     "  if (sl_own(a.D / 64) == 3)"),
)
#: the knockouts whose outputs are wrong by design (timed, not held)
_UNHELD = ("no_k_loads", "one_box")


def _cases(gen, waves=False):
    """(label, (q, kp, vp, table, q_start)) at chip_smoke's shapes; with
    ``waves``, also the D 512 and 2048 prefill rows at B 8 (``d512-b8``,
    ``d2048-b8``: four times the CTAs of their B 2 rows, so more than
    a wave of the SMs)."""
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
    more = [(f"d{d}-b8", 8, 96, 4, 2, d, 16, 20, torch.bfloat16,
             [0, 30] * 4, None) for d in (512, 2048)] if waves else []
    for label, b, t, h, kv, d, s, p, dtype, starts, _ in \
            rows + list(cs._PREFILL_GEOMETRIES + cs._POOL_GEOMETRIES) + more:
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
    other.add_argument("--tc-sliced", action="store_true",
                       help="the other version: this source with decode "
                            "past D 256 on the row-tile kernels")
    other.add_argument("--two-warpgroups", action="store_true",
                       help="the other version: this source with two "
                            "consumer warpgroups a sliced tensor-core CTA")
    other.add_argument("--no-k-loads", action="store_true",
                       help="the other version: this source with no K "
                            "loads in the sliced tensor-core kernel "
                            "(timed, not held)")
    other.add_argument("--one-box", action="store_true",
                       help="the other version: this source with each K "
                            "and V chunk of the sliced tensor-core kernel "
                            "one 64-slot box (timed, not held)")
    other.add_argument("--fit", metavar="OUTPUT",
                       help="no card: fit this version's sliced "
                            "tensor-core times in a saved output of this "
                            "script against each case's serial steps")
    ap.add_argument("--past-256", action="store_true",
                    help="only the cases past head dim 256")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.fit:
        return _fit(Path(args.fit))
    if not torch.cuda.is_available():
        print("paged_ab: CUDA is not available", file=sys.stderr)
        return 2
    this = (ROOT / "bigdl_tpu_torch/csrc/paged_attention.cu").read_text()
    past = []
    knockout = next((k for k in ("two_warpgroups", *_UNHELD)
                     if getattr(args, k)), None)
    if args.sliced or args.fold or args.tc_sliced or knockout:
        theirs = this
        for old, new in (SLICED_EVERYWHERE if args.sliced else ROW_PAST_G64
                         if args.fold else ROW_DECODE if args.tc_sliced
                         else TWO_WARPGROUPS if args.two_warpgroups
                         else NO_K_LOADS if args.no_k_loads else ONE_BOX):
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
        for label, case in _cases(torch.Generator().manual_seed(args.seed),
                                  waves=knockout in _UNHELD):
            q, kp = case[0], case[1]
            g = q.shape[2] // kp.shape[2]
            wide = q.shape[-1] > 256
            decode = q.shape[1] * g <= pa._SPLIT_ROWS
            route = pa.kernel_route(q.shape[1], q.shape[2], kp.shape[2],
                                    q.shape[-1], kp.shape[1],
                                    case[3].shape[1], kp.dtype)
            if ((wide or not (args.sliced or args.past_256
                              or args.tc_sliced or knockout))
                    and (not args.fold or g > 64)
                    and (not args.tc_sliced or (
                        decode and kp.dtype == torch.bfloat16))
                    and (not knockout or route == "tc_sliced")):
                row, bad = _ab(fns, label, case, card,
                               hold_other=knockout not in _UNHELD)
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


def _sliced_steps(t, d, s, p, starts):
    """The (key tile, 64-column chunk) steps of the sliced tensor-core
    kernel's CTA with the most keys: the row whose last query sits
    furthest, its pages padded to 8 slots, 64-key tiles, over all of D
    (built at the next multiple of 64)."""
    s8 = -(-s // 8) * 8
    tiles = max(-(-min(p, (x + t - 1) // s + 1) * s8 // 64) for x in starts)
    return tiles * -(-d // 64)


def _fit(path):
    """Least squares of this version's mean ms against ``_sliced_steps``
    over the ``_POOL_GEOMETRIES`` rows that ran "tc_sliced" in a saved
    output of this script: the fixed and per-step microseconds, and each
    case's deviation from the line."""
    geo = {r[0]: r for r in cs._POOL_GEOMETRIES}
    xs, ys, labels = [], [], []
    for line in path.read_text().splitlines():
        m = re.match(r"\[ab\] paged_attention (\S+) pool=\S+ card='[^']*' "
                     r"(\{.*\})$", line.strip())
        if not m or m.group(1) not in geo:
            continue
        row = json.loads(m.group(2))
        if row["routes"]["this"] != "tc_sliced":
            continue
        _, _, t, _, _, d, s, p, _, starts, _ = geo[m.group(1)]
        xs.append(_sliced_steps(t, d, s, p, starts))
        ys.append(1e3 * float(np.mean(row["this_ms"])))
        labels.append(m.group(1))
    if len(xs) < 2:
        print(f"[fit] fewer than 2 sliced tensor-core cases in {path}")
        return 1
    per_step, fixed = np.polyfit(xs, ys, 1)
    dev = {lb: round(y / (fixed + per_step * x) - 1, 4)
           for lb, x, y in zip(labels, xs, ys)}
    print(f"[fit] {len(xs)} cases of {path.name}: us = {fixed:.3f} + "
          f"{per_step:.4f} x steps (steps {min(xs)}-{max(xs)}); deviation "
          f"{min(dev.values()):+.4f} to {max(dev.values()):+.4f}: "
          + json.dumps(dev), flush=True)
    return 0


def _registers(report):
    """{kernel: "registers (spill store bytes)"} of the tensor-core
    prefill kernel at D 64, 128 and 256, of its sliced form (both
    instantiations) and of the bf16 split-KV kernel at D 128 (both row
    counts), from a ``-Xptxas=-v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        t = re.search(r"entry function '\S*?paged_prefill_tc_kernelILi(\d+)E",
                      line)
        sl = re.search(r"entry function '\S*?paged_prefill_sliced_tc_kernel"
                       r"ILi(\d+)E", line)
        sp = re.search(r"entry function '\S*?paged_decode_split_kernelI"
                       r"(\w+?)Li(\d+)ELi(\d+)E(?:Lb([01])E)?", line)
        if "entry function" in line:
            # the split kernel's instantiation at a built head dim (not
            # its PAD one)
            name = (f"tc D={t.group(1)}" if t and t.group(1) in (
                "64", "128", "256") else
                f"tc_sliced own={sl.group(1)}" if sl else
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


def _ab(fns, label, case, card, hold_other=True):
    """One case: both versions checked, then timed in turns; returns its
    row and the versions whose output is non-finite or past its limit,
    or whose route (this checkout's) is not the one ``kernel_route``
    names. Where the other version refuses the case (its entry returns
    an error), this version alone is checked and timed, the other's
    route None. Without ``hold_other`` the other version's error is
    printed, not held (a knockout that computes something else)."""
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
        if (version == "this" or hold_other) and not (
                worst[version] <= 1 and torch.isfinite(outs[version]).all()):
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

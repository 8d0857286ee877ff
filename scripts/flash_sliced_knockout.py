#!/usr/bin/env python3
"""Time the bf16 flash kernels past head dim 256 with one design choice
undone at a time, in turns, on one NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` as it is and copies
of it with one exact text replacement each (``VARIANTS``: the forward's
choices, then those of the sliced dq and dk/dv) into a temporary
directory, holds every version's outputs of the kernels a variant
changes against the plain versions (``chip_smoke``'s limits; dq and
dk/dv from the plain forward's lse and delta), then times those kernels
of each version in turns (the versions in order, then in reverse;
``chip_smoke._time_ms`` each: L2 flushed, median of 20), causal, at
``SHAPES``: D 512 at grids of 128, 256, 384 and 512 forward CTAs on the
card's 132 SMs (B2 S2048 H2 is ``chip_smoke``'s paired-mode row, B4
S4096 H2 ``perf -m attention``'s main-path shape), and D 384 and 576,
where slices are 3 chunks wide and Q is resident in the forward (and in
dq at D 384). dk/dv has no such choices left: the variants that paired
its key tiles or kept K and V resident measured no faster, and went. One
line per shape, version and kernel with both readings, their mean and
the ratio of means to this checkout's kernel; last, the card's name and
power limit. ``--only fwd`` or ``--only bwd`` builds and times one
side's variants alone. It exits 1 if a replacement's text is not in the
source (the line says which; an edit of those lines must update it) or
if any output is non-finite or past its limit, after every reading.

    python3 scripts/flash_sliced_knockout.py [--only fwd|bwd] [--seed N]
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

import chip_smoke  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

#: name -> (the kernels it changes, what it undoes, [(text in
#: flash_attention.cu, its replacement)])
VARIANTS = {
    "never_paired": (
        ("fwd",),
        "the CTA's query tiles always 128 consecutive rows (64 a "
        "warpgroup), the heaviest first",
        [("  const int paired = causal && grid.x * grid.y <= "
          "static_cast<unsigned>(sms);",
          "  const int paired = 0;")]),
    "always_paired": (
        ("fwd",),
        "the CTA's query tiles always i and n - 1 - i under the causal "
        "mask, whatever the grid",
        [("  const int paired = causal && grid.x * grid.y <= "
          "static_cast<unsigned>(sms);",
          "  const int paired = causal;")]),
    "no_broadcast": (
        ("fwd",),
        "the warpgroup index taken from tid / 128 directly, which ptxas "
        "treats as divergent",
        [("  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), "
          "l = tid % 32;",
          "  const int g = tid / 128, l = tid % 32;")]),
    "ring4": (
        ("fwd",),
        "a ring of at most 4 stages of K chunks",
        [("constexpr int kSlMaxStages = 16;",
          "constexpr int kSlMaxStages = 4;")]),
    "q_streamed": (
        ("fwd",),
        "Q chunks always through the ring with K, never resident",
        [("  const bool q_res = sl_smem(nc, OWN, true, kSlMinStages) <= "
          "kSmemMax;",
          "  const bool q_res = false;")]),
    "own4": (
        ("fwd",),
        "slices of 4 chunks at every D (the last one partly past D), "
        "no slices of 3",
        [("  if (sl_own(D / 64) == 3)\n", "  if (false)\n")]),
    "dq_never_paired": (
        ("dq",),
        "dq: the CTA's query tiles always 128 consecutive rows, the "
        "heaviest first",
        [("  const int dq_paired =\n      causal && grid.x * grid.y <= "
          "static_cast<unsigned>(sms);",
          "  const int dq_paired = 0;")]),
    "dq_always_paired": (
        ("dq",),
        "dq: query tiles i and n - 1 - i under the causal mask, whatever "
        "the grid",
        [("  const int dq_paired =\n      causal && grid.x * grid.y <= "
          "static_cast<unsigned>(sms);",
          "  const int dq_paired = causal;")]),
    "dq_streamed": (
        ("dq",),
        "dq: Q chunks always through the ring with K, V and dO, never "
        "resident",
        [("  const bool q_res = dq_smem(nc, OWN, true, kDqMinStages) <= "
          "kSmemMax;",
          "  const bool q_res = false;")]),
    "dq_min2": (
        ("dq",),
        "dq: Q resident where a ring of 2 stages fits beside it, not 3 "
        "(Q resident up to D 512)",
        [("constexpr int kDqMinStages = 3;",
          "constexpr int kDqMinStages = 2;")]),
    "bwd_own3": (
        ("dq", "dkdv"),
        "dq and dk/dv: slices of at most 3 chunks (3 + 3 + 2 at D 512), "
        "one more recompute of the score products",
        [("  return sl_own(D / 64) == 3\n             ? dq_sliced_own<3>(",
          "  return true\n             ? dq_sliced_own<3>("),
         ("  return sl_own(D / 64) == 3\n             ? dkdv_sliced_own<3>(",
          "  return true\n             ? dkdv_sliced_own<3>(")]),
}
#: (B, S, H, D), causal
SHAPES = ((2, 2048, 2, 512), (2, 4096, 2, 512), (3, 4096, 2, 512),
          (4, 4096, 2, 512), (2, 2048, 2, 384), (2, 2048, 2, 576))


def _variant_sources(text: str) -> tuple[dict, list]:
    """This checkout's source and each variant's; the replacements whose
    text is not found."""
    out, missing = {"this": text}, []
    for name, (_, _, edits) in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                missing.append(f"{name}: {old.strip()!r}")
            src = src.replace(old, new)
        out[name] = src
    return out, missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("fwd", "bwd"),
                    help="the forward's variants, or the backward's")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_sliced_knockout: CUDA is not available",
              file=sys.stderr)
        return 2
    chosen_variants = {
        name: v for name, v in VARIANTS.items()
        if args.only is None or (v[0] == ("fwd",)) == (args.only == "fwd")}
    sources, past = _variant_sources(
        (ROOT / "bigdl_tpu_torch/csrc/flash_attention.cu").read_text())
    sources = {k: v for k, v in sources.items()
               if k == "this" or k in chosen_variants}
    if past:
        print("[knockout] replacement text not found: " + "; ".join(past),
              flush=True)
    kernels = {name: v[0] for name, v in chosen_variants.items()}
    kernels["this"] = tuple(k for k in ("fwd", "dq", "dkdv")
                            if any(k in ks for ks in kernels.values()))
    for name, (_, what, _) in chosen_variants.items():
        print(f"[knockout] {name}: {what}", flush=True)
    card = chip_smoke._card()
    chosen = fa._kernel_fns
    gen = torch.Generator().manual_seed(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            fns = dict(zip(sources, pool.map(
                lambda kv: fa.bind(_build.build_copy(kv[1],
                                                     Path(tmp) / kv[0])),
                sources.items())))
        chip_smoke._warm_card()
        try:
            for shape in SHAPES:
                past += _shape(fns, kernels, gen, *shape, card)
        finally:
            fa._kernel_fns = chosen
    if past:
        print("[knockout] failed: " + "; ".join(past), flush=True)
    print(card)
    return 1 if past else 0


def _shape(fns, kernels, gen, b, s, h, d, card):
    """Every version at one shape: the kernels it changes checked, then
    timed in turns; returns the outputs that are non-finite or past
    their limit."""
    scale = d ** -0.5
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen)
                   .to(torch.bfloat16).to(chip_smoke._DEV)
                   for _ in range(4))
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, True)
    delta = (do.float() * ro.float()).sum(-1)
    calls = {
        "fwd": lambda: fa.flash_fwd(q, k, v, scale, True),
        "dq": lambda: fa.flash_dq(q, k, v, do, rlse, delta, scale, True),
        "dkdv": lambda: fa.flash_dkdv(q, k, v, do, rlse, delta, scale,
                                      True),
    }
    wanted = set(kernels["this"])
    refs = {}
    if "fwd" in wanted:
        refs["fwd"] = (("o", ro), ("lse", rlse))
    if "dq" in wanted:
        refs["dq"] = (("dq", fa.flash_dq_ref(q, k, v, do, rlse, delta,
                                             scale, True)),)
    if "dkdv" in wanted:
        refs["dkdv"] = tuple(zip(("dk", "dv"), fa.flash_dkdv_ref(
            q, k, v, do, rlse, delta, scale, True)))
    past = []
    for version, fn in fns.items():
        fa._kernel_fns = lambda f=fn: f
        for kernel in kernels[version]:
            got = calls[kernel]()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            worst = {what: chip_smoke._flash_err(what, g, ref)[1]
                     for (what, ref), g in zip(refs[kernel], got)}
            if not (all(w <= 1 for w in worst.values())
                    and all(torch.isfinite(g.float()).all() for g in got)):
                past.append(f"{version} {kernel} B={b} S={s} D={d}: "
                            f"{worst}")
            print(f"[knockout] check {version} {kernel} B={b} S={s} H={h} "
                  f"D={d} causal worst error / limit " + json.dumps(worst),
                  flush=True)
            del got
    del refs, ro
    times = {(version, kernel): [] for version in fns
             for kernel in kernels[version]}
    for version in [*fns, *reversed(fns)]:
        fa._kernel_fns = lambda f=fns[version]: f
        for kernel in kernels[version]:
            times[(version, kernel)].append(
                chip_smoke._time_ms(calls[kernel]))
    for (version, kernel), t in times.items():
        base = float(np.mean(times[("this", kernel)]))
        print(f"[knockout] flash_{kernel}[bfloat16] {version} B={b} S={s} "
              f"H={h} D={d} causal card='{card}' " + json.dumps(dict(
                  ms=t, mean_ms=float(np.mean(t)),
                  ratio=float(np.mean(t)) / base)), flush=True)
    return past


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the bf16 flash forward past head dim 256 with one design choice
undone at a time, in turns, on one NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` as it is and copies
of it with one exact text replacement each (``VARIANTS``) into a
temporary directory, holds every version's o and lse against the plain
version (``chip_smoke``'s limits), then times ``flash_fwd`` of each in
turns (the versions in order, then in reverse; ``chip_smoke._time_ms``
each: L2 flushed, median of 20), causal, at ``SHAPES``: D 512 at grids
of 128, 256, 384 and 512 CTAs on the card's 132 SMs (B2 S2048 H2 is
``chip_smoke``'s paired-mode row, B4 S4096 H2 ``perf -m attention``'s
main-path shape), and D 384 and 576, where slices are 3 chunks wide
and Q is resident. One line per shape and version with both readings,
their mean and the ratio of means to this checkout's kernel; last, the
card's name and power limit. It exits 1 if a replacement's text is not
in the source (the line says which; an edit of those lines must update
it) or if any output is non-finite or past its limit, after every
reading.

    python3 scripts/flash_sliced_knockout.py [--seed N]
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

#: name -> (what it undoes, [(text in flash_attention.cu, its
#: replacement)])
VARIANTS = {
    "never_paired": (
        "the CTA's query tiles always 128 consecutive rows (64 a "
        "warpgroup), the heaviest first",
        [("  const int paired = causal && grid.x * grid.y <= "
          "static_cast<unsigned>(sms);",
          "  const int paired = 0;")]),
    "always_paired": (
        "the CTA's query tiles always i and n - 1 - i under the causal "
        "mask, whatever the grid",
        [("  const int paired = causal && grid.x * grid.y <= "
          "static_cast<unsigned>(sms);",
          "  const int paired = causal;")]),
    "no_broadcast": (
        "the warpgroup index taken from tid / 128 directly, which ptxas "
        "treats as divergent",
        [("  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), "
          "l = tid % 32;",
          "  const int g = tid / 128, l = tid % 32;")]),
    "ring4": (
        "a ring of at most 4 stages of K chunks",
        [("constexpr int kSlMaxStages = 16;",
          "constexpr int kSlMaxStages = 4;")]),
    "q_streamed": (
        "Q chunks always through the ring with K, never resident",
        [("  const bool q_res = sl_smem(nc, OWN, true, kSlMinStages) <= "
          "kSmemMax;",
          "  const bool q_res = false;")]),
    "own4": (
        "slices of 4 chunks at every D (the last one partly past D), "
        "no slices of 3",
        [("  if (sl_own(D / 64) == 3)\n", "  if (false)\n")]),
}
#: (B, S, H, D), causal
SHAPES = ((2, 2048, 2, 512), (2, 4096, 2, 512), (3, 4096, 2, 512),
          (4, 4096, 2, 512), (2, 2048, 2, 384), (2, 2048, 2, 576))


def _variant_sources(text: str) -> tuple[dict, list]:
    """This checkout's source and each variant's; the replacements whose
    text is not found."""
    out, missing = {"this": text}, []
    for name, (_, edits) in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                missing.append(f"{name}: {old.strip()!r}")
            src = src.replace(old, new)
        out[name] = src
    return out, missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_sliced_knockout: CUDA is not available",
              file=sys.stderr)
        return 2
    sources, past = _variant_sources(
        (ROOT / "bigdl_tpu_torch/csrc/flash_attention.cu").read_text())
    if past:
        print("[knockout] replacement text not found: " + "; ".join(past),
              flush=True)
    for name, (what, _) in VARIANTS.items():
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
                past += _shape(fns, gen, *shape, card)
        finally:
            fa._kernel_fns = chosen
    if past:
        print("[knockout] failed: " + "; ".join(past), flush=True)
    print(card)
    return 1 if past else 0


def _shape(fns, gen, b, s, h, d, card):
    """Every version at one shape: checked, then timed in turns; returns
    the outputs that are non-finite or past their limit."""
    scale = d ** -0.5
    q, k, v = (torch.randn((b, s, h, d), generator=gen)
               .to(torch.bfloat16).to(chip_smoke._DEV) for _ in range(3))
    ro, rlse = fa.flash_fwd_ref(q, k, v, scale, True)
    past = []
    for version, fn in fns.items():
        fa._kernel_fns = lambda f=fn: f
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        torch.cuda.synchronize()
        worst = {what: chip_smoke._flash_err(what, got, ref)[1]
                 for what, got, ref in (("o", o, ro), ("lse", lse, rlse))}
        if not (all(w <= 1 for w in worst.values())
                and torch.isfinite(o.float()).all()):
            past.append(f"{version} B={b} S={s}: {worst}")
        print(f"[knockout] check {version} B={b} S={s} H={h} D={d} causal "
              f"worst error / limit " + json.dumps(worst), flush=True)
    del ro, rlse
    times = {version: [] for version in fns}
    for version in [*fns, *reversed(fns)]:
        fa._kernel_fns = lambda f=fns[version]: f
        times[version].append(chip_smoke._time_ms(
            lambda: fa.flash_fwd(q, k, v, scale, True)))
    base = float(np.mean(times["this"]))
    for version, t in times.items():
        print(f"[knockout] flash_fwd[bfloat16] {version} B={b} S={s} H={h} "
              f"D={d} causal card='{card}' " + json.dumps(dict(
                  ms=t, mean_ms=float(np.mean(t)),
                  ratio=float(np.mean(t)) / base)), flush=True)
    return past


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the transformer train step of two checkouts in turns on one card.

Runs the throughput harness (``bigdl_tpu_torch.models.utils.perf -m
transformer``) at ``chip_smoke.py``'s ``[perf]`` geometry (B4 S2048,
vocab 32768, d_model 1024, 8 heads of 128, 12 layers; ``--dataType``
f32 by default; ``--dModel`` and ``--numLayers`` change the width, with
d_model / 128 heads, and the depth: ``--dModel 2048 --numLayers 2`` is
``chip_smoke._PERF_WIDE``'s step) for this checkout and for the one
whose root is ``--other`` (such as a ``git archive`` of the parent
unpacked under the git-ignored ``build/``), each in a process of its
own started from that checkout's root, in turns: other, this, this,
other. Prints each run's ms a step (host clock over the timed steps,
ending in the loss readback), tokens/s, peak device bytes and first and
last loss, then the ratio of the means (this / other) and the largest
peak of each, and last the card's name and power limit. It exits 1 if a
run fails or a loss is not finite.

    python3 scripts/step_ab.py --other DIR [--dataType f32|bf16]
        [--dModel 1024] [--numLayers 12] [--warmUp 2] [-i 8]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_ORDER = ("other", "this", "this", "other")
_KEYS = ("ms_per_step", "tokens_per_s", "peak_bytes", "first_loss",
         "final_loss")
#: the child: the harness's main from the checkout it starts in, one JSON
#: line of its numbers
_RUN = ("import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from bigdl_tpu_torch.models.utils import perf\n"
        "out = perf.main(sys.argv[1:])\n"
        "print('[step_ab] ' + json.dumps({k: out[k] for k in "
        + repr(_KEYS) + "}), flush=True)\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the root of the other checkout")
    ap.add_argument("--dataType", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--dModel", type=int,
                    default=chip_smoke._PERF["d_model"])
    ap.add_argument("--numLayers", type=int,
                    default=chip_smoke._PERF["layers"])
    ap.add_argument("--warmUp", type=int, default=2)
    ap.add_argument("-i", "--iteration", type=int, default=8)
    args = ap.parse_args(argv)
    harness = chip_smoke._perf_args(warm_up=args.warmUp,
                                    iterations=args.iteration,
                                    d_model=args.dModel,
                                    layers=args.numLayers) + [
        "--dataType", args.dataType]
    roots = {"this": ROOT, "other": Path(args.other).resolve()}
    runs = {"this": [], "other": []}
    for who in _ORDER:
        done = subprocess.run([sys.executable, "-c", _RUN, *harness],
                              cwd=roots[who], capture_output=True,
                              text=True, timeout=900)
        line = [x for x in done.stdout.splitlines()
                if x.startswith("[step_ab] ")]
        if done.returncode or not line:
            print(f"[step_ab] {who} failed (rc {done.returncode}): "
                  + done.stderr[-2000:], flush=True)
            return 1
        got = json.loads(line[-1][len("[step_ab] "):])
        runs[who].append(got)
        print(f"[step_ab] {who} ({roots[who]}) " + json.dumps(got),
              flush=True)
        if not all(math.isfinite(got[k]) for k in ("first_loss",
                                                   "final_loss")):
            print(f"[step_ab] {who}: a loss is not finite", flush=True)
            return 1
    ms = {who: [r["ms_per_step"] for r in rs] for who, rs in runs.items()}
    print("[step_ab] transformer " + json.dumps(harness[1:]) + " "
          + json.dumps(dict(
              this_ms=ms["this"], other_ms=ms["other"],
              ratio=float(np.mean(ms["this"]) / np.mean(ms["other"])),
              this_peak_bytes=max(r["peak_bytes"] for r in runs["this"]),
              other_peak_bytes=max(r["peak_bytes"]
                                   for r in runs["other"]))), flush=True)
    print(chip_smoke._card())
    return 0


if __name__ == "__main__":
    sys.exit(main())

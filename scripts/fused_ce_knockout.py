#!/usr/bin/env python3
"""Where the bf16 fused-CE kernels spend their time, on one NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/fused_ce.cu`` as it is and in copies with
one part of the thread-block-cluster path knocked out (written to a
temporary directory, never into the checkout), and times the forward,
dh and dW/db at the harness head's shapes (N 8192, V 32768, D 1024,
bf16; ``chip_smoke.py``'s inputs and timing: L2 flushed, median of 20).
A knocked-out copy computes wrong values; only its time is read:

- ``no_cluster_sync``: no cluster barrier between the partial logits
  tiles and the epilogue that sums them;
- ``local_parts_only``: the epilogue reads its own CTA's partial tile
  four times instead of the four CTAs' tiles through distributed shared
  memory;
- ``no_partial_mma``: no tensor-core products for the partial logits;
- ``no_accumulate``: no dlogits·X products into the dh / dW accumulator
  (backward only).

    python3 scripts/fused_ce_knockout.py [--seed N]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402
from bigdl_tpu_torch.ops import fused_ce as fce  # noqa: E402

KNOCKOUTS = {
    "no_cluster_sync": (
        "    cluster.sync();                        // the four partials "
        "are complete\n", ""),
    "local_parts_only": (
        "parts[q] = cluster.map_shared_rank(p, q);", "parts[q] = p;"),
    "no_partial_mma": (
        "      mma(c[2 * j], a, b[0], b[1]);\n"
        "      mma(c[2 * j + 1], a, b[2], b[3]);\n", ""),
    "no_accumulate": ("    accumulate_tc(acc, G, xs);\n", ""),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ce_knockout: CUDA is not available", file=sys.stderr)
        return 2
    src = (ROOT / "bigdl_tpu_torch/csrc/fused_ce.cu").read_text()
    sources = {"as_is": src}
    for name, (old, new) in KNOCKOUTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the line it knocks out has moved; "
                               f"update the knockouts")
        sources[name] = src.replace(old, new)
    gen = torch.Generator().manual_seed(args.seed)
    n, v, d = 8192, 32768, 1024
    h, w, b, t, g = chip_smoke._fce_inputs(n, v, d, torch.bfloat16, gen,
                                           False)
    _, lse = fce.fused_ce_fwd_ref(h, w, b, t)
    card = chip_smoke._card()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            libs = dict(zip(sources, pool.map(
                lambda kv: _build.build_copy(kv[1], Path(tmp) / kv[0]),
                sources.items())))
        for name, lib in libs.items():
            fns = fce.bind(lib)
            fce._kernel_fns = lambda fns=fns: fns
            ms = {"fwd": chip_smoke._time_ms(
                      lambda: fce.fused_ce_fwd(h, w, b, t)),
                  "dh": chip_smoke._time_ms(
                      lambda: fce.fused_ce_dh(h, w, b, t, lse, g)),
                  "dw": chip_smoke._time_ms(
                      lambda: fce.fused_ce_dw(h, w, b, t, lse, g))}
            print(f"[knockout] card='{card}' N={n} V={v} D={d} bf16 "
                  f"{name}: ms " + json.dumps(ms), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

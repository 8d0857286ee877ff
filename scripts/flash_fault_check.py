#!/usr/bin/env python3
"""Planted-fault check of ``chip_smoke.py``'s flash forward tolerance on
one NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` as it is and in
broken copies (written to a temporary directory, never into the
checkout), runs each forward at the training shapes (B4 S2048 H8 D128,
bf16, causal) and prints, for each, o's max abs error against the plain
version and its worst error over the elementwise limit that
``chip_smoke.py`` applies (pass: <= 1), beside the limit it applied
before, 1e-2 x max(1, max|plain|).

The faults, each in the forward kernel's last key tile (the diagonal
one) of every query tile after the first, where a prefetch-free final
iteration could pick the wrong half of the K/V double buffer:

- ``v_prev_tile``: P·V reads V of the previous key tile;
- ``v_prev_tile_late``: the same, in the query tiles of the second half
  of the sequence only (late rows average many keys, so their |o| is
  small and a wrong V moves them least);
- ``v_prev_tile_last``: the same, in the last query tile only.

    python3 scripts/flash_fault_check.py [--seed N]
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
from bigdl_tpu_torch.ops import flash_attention as fa  # noqa: E402

_V_LINE = "    const T* vs = ks + kT;\n"   # the forward's V tile, first match
_PREV = "kv + ((kt - 1) & 1) * 2 * kT + kT"
FAULTS = {
    "v_prev_tile": f"    const T* vs = (kt >= 1 && kt == nkt - 1) ? {_PREV}"
                   f" : ks + kT;\n",
    "v_prev_tile_late": f"    const T* vs = (kt >= 1 && kt == nkt - 1 && "
                        f"2 * q0 >= Sq) ? {_PREV} : ks + kT;\n",
    "v_prev_tile_last": f"    const T* vs = (kt >= 1 && kt == nkt - 1 && "
                        f"q0 + kTile >= Sq) ? {_PREV} : ks + kT;\n",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_fault_check: CUDA is not available", file=sys.stderr)
        return 2
    src = (ROOT / "bigdl_tpu_torch/csrc/flash_attention.cu").read_text()
    if src.count(_V_LINE) != 2:         # forward first, then dq
        raise RuntimeError("the forward's V tile line has moved; update "
                           "the planted faults")
    sources = {"sound": src, **{name: src.replace(_V_LINE, line, 1)
                                for name, line in FAULTS.items()}}
    b, s, h, d = 4, 2048, 8, 128
    gen = torch.Generator().manual_seed(args.seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen)
               .to(torch.bfloat16).cuda() for _ in range(3))
    want, _ = fa.flash_fwd_ref(q, k, v, d ** -0.5, True)
    old_limit = 1e-2 * max(1.0, float(want.float().abs().max()))
    rms = float(want.float().square().mean().sqrt())
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            libs = dict(zip(sources, pool.map(
                lambda kv: _build.build_copy(kv[1], Path(tmp) / kv[0]),
                sources.items())))
        for name, lib in libs.items():
            fns = fa.bind(lib)
            fa._kernel_fns = lambda fns=fns: fns
            o, _ = fa.flash_fwd(q, k, v, d ** -0.5, True)
            torch.cuda.synchronize()
            err, worst = chip_smoke._flash_err("o", o, want)
            print(f"[fault] {name}: " + json.dumps(dict(
                max_abs_err=err, worst_over_limit=worst,
                caught=not worst <= 1, old_limit=old_limit,
                caught_by_old=not err <= old_limit, rms_o=rms,
                max_abs_o=float(want.float().abs().max()))), flush=True)
    print(chip_smoke._card())
    return 0


if __name__ == "__main__":
    sys.exit(main())

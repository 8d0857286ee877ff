#!/usr/bin/env python3
"""Where the bf16 fused-CE kernels spend their time, on one NVIDIA card.

Builds ``bigdl_tpu_torch/csrc/fused_ce.cu`` as it is and in copies with
one part knocked out (written to a temporary directory, never into the
checkout), and times the kernels a part belongs to at the harness head's
shapes (N 8192, V 32768, D 1024, bf16; ``chip_smoke.py``'s inputs and
timing: L2 flushed, median of 20). A knocked-out copy computes wrong
values; only its time is read.

The backward, dh and dW/db (``fce_bwd_tc_kernel``: wgmma fed by TMA):

- ``bwd_no_cluster_sum``: the epilogue reads its own CTA's partial logits
  four times instead of the four CTAs' through distributed shared memory;
- ``bwd_no_dl_broadcast``: the epilogue writes its dl rows into its own
  CTA's tile only, not into the three others';
- ``bwd_no_partial_wgmma``: no wgmma for the partial logits;
- ``bwd_no_accumulate_wgmma``: no wgmma adding dl·X into the accumulator;
- ``bwd_no_tma_wait``: no wait for an X tile's TMA load to land;
- ``bwd_no_cluster_sync``: no cluster barriers in the walk (neither the
  one before the cluster sum nor the one before the accumulate), one at
  the kernel's end.

The forward (``fce_fwd_cluster_kernel``: mma.sync, cp.async):

- ``fwd_no_cluster_sync``: no cluster barrier between the partial logits
  tiles and the epilogue that sums them;
- ``fwd_local_parts_only``: the epilogue reads its own CTA's partial tile
  four times instead of the four CTAs' tiles;
- ``fwd_no_partial_mma``: no tensor-core products for the partial logits.

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

# name -> (kernels it belongs to, [(text, its replacement, occurrences)])
KNOCKOUTS = {
    "bwd_no_cluster_sum": (("dh", "dw"), [(
        "const float* part = cluster.map_shared_rank(P, q) + er * kPP + ec;",
        "const float* part = P + er * kPP + ec;", 1)]),
    "bwd_no_dl_broadcast": (("dh", "dw"), [(
        "*reinterpret_cast<uint4*>(cluster.map_shared_rank(G, q) + off) = v;",
        "*reinterpret_cast<uint4*>(G + off) = v;", 1)]),
    "bwd_no_partial_wgmma": (("dh", "dw"), [(
        "    wgmma_ss_n64(s, desc_k<kRows>(rs, 64 * wg, kk), "
        "desc_k<kX>(xs, 0, kk),\n                 kk > 0);\n", "    ;\n", 1)]),
    "bwd_no_accumulate_wgmma": (("dh", "dw"), [(
        "    wgmma_rs_n256_tb(acc, a[kk], desc_mn_wide<kX>(xs, kk));\n",
        "    ;\n", 1)]),
    "bwd_no_tma_wait": (("dh", "dw"), [(
        "    if (tn > t) warp_wait(ring.full(tn % kStages), "
        "(tn / kStages) & 1);\n", "", 1)]),
    "fwd_no_cluster_sync": (("fwd",), [(
        "    cluster.sync();                        // the four partials "
        "are complete\n", "", 1)]),
    "fwd_local_parts_only": (("fwd",), [(
        "parts[q] = cluster.map_shared_rank(p, q);", "parts[q] = p;", 1)]),
    "fwd_no_partial_mma": (("fwd",), [(
        "      mma(c[2 * j], a, b[0], b[1]);\n"
        "      mma(c[2 * j + 1], a, b[2], b[3]);\n", "", 1)]),
    # last: without its barriers a CTA could leave while a peer still
    # reads its shared memory, so one barrier stays at the kernel's end
    "bwd_no_cluster_sync": (("dh", "dw"), [
        ("    cluster_arrive();\n", "", 2),
        ("    cluster_wait();\n", "", 1),
        ("    cluster_wait();                        // every CTA's dl tile "
         "is complete\n", "", 1),
        ("  wg_wait();\n  keep(acc);\n\n",
         "  wg_wait();\n  keep(acc);\n  cluster.sync();\n\n", 1)]),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ce_knockout: CUDA is not available", file=sys.stderr)
        return 2
    src = (ROOT / "bigdl_tpu_torch/csrc/fused_ce.cu").read_text()
    sources = {"as_is": (("fwd", "dh", "dw"), src)}
    for name, (kernels, edits) in KNOCKOUTS.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: the text it knocks out has "
                                   f"moved; update the knockouts")
            text = text.replace(old, new)
        sources[name] = (kernels, text)
    gen = torch.Generator().manual_seed(args.seed)
    n, v, d = 8192, 32768, 1024
    h, w, b, t, g = chip_smoke._fce_inputs(n, v, d, torch.bfloat16, gen,
                                           False)
    _, lse = fce.fused_ce_fwd_ref(h, w, b, t)
    calls = {"fwd": lambda: fce.fused_ce_fwd(h, w, b, t),
             "dh": lambda: fce.fused_ce_dh(h, w, b, t, lse, g),
             "dw": lambda: fce.fused_ce_dw(h, w, b, t, lse, g)}
    card = chip_smoke._card()
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            libs = dict(zip(sources, pool.map(
                lambda kv: _build.build_copy(kv[1][1], Path(tmp) / kv[0]),
                sources.items())))
        for name, lib in libs.items():
            fns = fce.bind(lib)
            fce._kernel_fns = lambda fns=fns: fns
            ms = {k: chip_smoke._time_ms(calls[k]) for k in sources[name][0]}
            print(f"[knockout] card='{card}' N={n} V={v} D={d} bf16 "
                  f"{name}: ms " + json.dumps(ms), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

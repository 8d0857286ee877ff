#!/usr/bin/env python3
"""Where the bf16 fused-CE kernels spend their time, on one NVIDIA card,
and a planted fault in the forward against ``chip_smoke.py``'s limit.

Builds ``bigdl_tpu_torch/csrc/fused_ce.cu`` as it is and in copies with
one part knocked out or one fault planted (written to a temporary
directory, never into the checkout), and times the kernels a part
belongs to at the harness head's shapes (N 8192, V 32768, D 1024, bf16;
``chip_smoke.py``'s inputs and timing: L2 flushed, median of 20). A
knocked-out copy computes wrong values; only its time is read.

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

The forward (``fce_fwd_tc_kernel``: wgmma fed by TMA, a producer
warpgroup):

- ``fwd_no_epilogue``: no epilogue (bias, mask, target, max, ``ex2``):
  the products, the loads and the ring alone;
- ``fwd_no_tma_load``: the producer completes each stage's barrier with
  a plain arrival and loads nothing: the products and the epilogue
  without the L2 traffic (the wait itself stays: with a producer that
  runs ahead, knocking out the consumers' wait would leave bulk copies in
  flight when the CTA exits and stack arrivals on one barrier phase);
- ``fwd_no_wgmma``: no wgmma: the loads, the ring and the epilogue;
- ``fwd_no_setmaxnreg``: a design option, not a knockout: a producer
  warp (288 threads) and no ``setmaxnreg``, so that ptxas caps every
  thread at 168 registers (a scheduler holds three of the nine warps),
  too few for the accumulator and the epilogue;
- ``fwd_skewed_warpgroups``: a design option, not a knockout: warpgroup
  1 starts two ring stages after warpgroup 0 (a named barrier), so that
  one warpgroup's epilogue could run beside the other's products.

The design options compute right values; their nll and lse errors are
printed as the faults' are.

``fwd_no_epilogue`` still adds one accumulator element and one bias to a
sum: with nothing reading the accumulator, ptxas deletes most of the
wgmma (their results go nowhere) and the copy times a fraction of the
products.

The planted faults, in the forward, where the products could be handed
the wrong stage of the ring (their nll and lse are held against the
plain version as ``chip_smoke.py`` holds them, absolutely at
``_FCE_ABS_TOL``; the sound kernel's reading is printed beside them):

- ``w_prev_stage``: the last D box of every vocab tile reads its W box
  from the previous ring stage (the previous box's 64 feature columns);
- ``w_prev_stage_last_tile``: the same, in each split's last vocab tile
  only.

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
    "fwd_no_epilogue": (("fwd",), [(
        "    fold(acc, bias, c0, tcol, m, ls, tl);\n",
        "    ls[0] += acc[0] + bias[0].x;\n", 1)]),
    "fwd_no_tma_load": (("fwd",), [(
        "        bar_expect(ring.full(st), kFwdStage);\n"
        "        tma_load_2d(dst, &hm, ring.full(st), d0, r0);\n"
        "        tma_load_2d(dst + kHBox, &wm, ring.full(st), d0,\n"
        "                    (t0 + i / nb) * kFwdCols);\n",
        "        bar_arrive(ring.full(st));\n", 1)]),
    "fwd_no_setmaxnreg": (("fwd",), [
        ("kFwdThreads = kConsumers + 128;", "kFwdThreads = kConsumers + 32;",
         1),
        ("    regs_dec<kProducerRegs>();\n", "", 1),
        ("  regs_inc<kConsumerRegs>();\n", "", 1)]),
    "fwd_skewed_warpgroups": (("fwd",), [
        ("  float acc[128];\n  zero(acc);\n",
         "  if (wg == 1) asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");"
         "\n  float acc[128];\n  zero(acc);\n", 1),
        ("      wg_commit();\n      if (kb > 0) {",
         "      wg_commit();\n      if (wg == 0 && i == min(2, nt * nb) - 1)\n"
         "        asm volatile(\"bar.arrive 1, 256;\\n\" ::: \"memory\");\n"
         "      if (kb > 0) {", 1)]),
    "fwd_no_wgmma": (("fwd",), [(
        "        wgmma_ss_n256(acc, desc_k<kFwdRows>(hs, 64 * wg, kk),\n"
        "                      desc_k<kFwdCols>(ws, 0, kk), kb > 0 || kk > 0);"
        "\n", "        ;\n", 1)]),
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


# the forward's stage line, and the W stage of the previous box
_STAGE_LINE = ("      const uint32_t hs = ring.base + st * kFwdStage, "
               "ws = hs + kHBox;\n")
_PREV = "ring.base + ((i - 1) % kFwdStages) * kFwdStage + kHBox"
FAULTS = {
    "w_prev_stage": "kb == nb - 1",
    "w_prev_stage_last_tile": "kb == nb - 1 && t == nt - 1",
}
DESIGNS = ("fwd_no_setmaxnreg", "fwd_skewed_warpgroups")


def _fault_source(src: str, where: str) -> str:
    return src.replace(_STAGE_LINE, (
        "      const uint32_t hs = ring.base + st * kFwdStage;\n"
        f"      const uint32_t ws = i >= 1 && {where} ? {_PREV} : "
        "hs + kHBox;\n"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ce_knockout: CUDA is not available", file=sys.stderr)
        return 2
    src = (ROOT / "bigdl_tpu_torch/csrc/fused_ce.cu").read_text()
    if src.count(_STAGE_LINE) != 1:
        raise RuntimeError("the forward's stage line has moved; update the "
                           "planted faults")
    sources = {"as_is": (("fwd", "dh", "dw"), src)}
    for name, (kernels, edits) in KNOCKOUTS.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: the text it knocks out has "
                                   f"moved; update the knockouts")
            text = text.replace(old, new)
        sources[name] = (kernels, text)
    for name, where in FAULTS.items():
        sources[name] = ((), _fault_source(src, where))
    gen = torch.Generator().manual_seed(args.seed)
    n, v, d = 8192, 32768, 1024
    h, w, b, t, g = chip_smoke._fce_inputs(n, v, d, torch.bfloat16, gen,
                                           False)
    rnll, lse = fce.fused_ce_fwd_ref(h, w, b, t)
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
            if name == "as_is" or name in FAULTS or name in DESIGNS:
                nll, got_lse = fce.fused_ce_fwd(h, w, b, t)
                torch.cuda.synchronize()
                row = {}
                for what, got, want in (("nll", nll, rnll),
                                        ("lse", got_lse, lse)):
                    err = float((got - want).abs().max())
                    row[f"{what}_max_abs_err"] = err
                    row[f"{what}_over_limit"] = err / chip_smoke._FCE_ABS_TOL
                worst = max(row["nll_over_limit"], row["lse_over_limit"])
                tag = "design" if name in DESIGNS else "fault"
                print(f"[{tag}] {name}: caught={not worst <= 1} "
                      + json.dumps(row) + f" (limit {chip_smoke._FCE_ABS_TOL}"
                      f" absolute)", flush=True)
            ms = {k: chip_smoke._time_ms(calls[k]) for k in sources[name][0]}
            if ms:
                print(f"[knockout] card='{card}' N={n} V={v} D={d} bf16 "
                      f"{name}: ms " + json.dumps(ms), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

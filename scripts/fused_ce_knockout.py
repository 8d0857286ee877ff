#!/usr/bin/env python3
"""Where the fused-CE kernels spend their time, on one NVIDIA card, and a
planted fault in the forward against ``chip_smoke.py``'s limit.

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

``--only tf32`` instead times the f32 kernels, the forward
(``fce_fwd_tf32_kernel``) and dh and dW/db (``fce_bwd_tf32_kernel``:
two-CTA clusters), 3xTF32 on the tensor cores, at the same shapes in
f32, each version's outputs held against the f32 plain versions at
``chip_smoke``'s limits and against the function evaluated in float64
(the ratio to the same limit), then timed in turns (the versions in
order, then in reverse). The backward's versions:

- ``chained_score``, ``chained_out``: the precision knockouts of
  ``flash_sliced_knockout.py`` (the score products, or the output
  products, summed in one tensor-core chain, not in fresh sums), applied
  to ``tf32.cuh``'s steps, which every version here builds inlined;
  their errors are the reading, held to nothing;
- ``recompute_per_slice``: the design not kept for the D-wide
  accumulator: each CTA of a cluster forms the logits over all of D (its
  warpgroups half each) instead of half and an exchange through
  distributed shared memory;
- what sets the pace, one part out at a time (wrong values, read for
  their time): ``no_tma_load`` (no L2 traffic into the ring),
  ``no_a_split`` (A's parts not split in registers), ``no_exchange``
  (no exchange between the cluster's CTAs), ``no_dl`` (no dl formed:
  no exp, no column values), ``no_score_wgmma`` and ``no_out_wgmma``
  (no products in the score or the output steps).

The forward's versions (``TF32_FWD_KNOCKOUTS``):

- ``fwd_chained_score``: the score products summed in one tensor-core
  chain over all of a tile's D (no fresh sum a score step), read against
  float64 and held to nothing;
- ``fwd_select_first_step``: the design not kept for the logits tile:
  set from a tile's first step by a select in every step, not zeroed at
  the tile's start; held to the limits;
- ``fwd_a_parts_split_pass``: the design option not kept for A: h's
  tf32 parts from a second split pass (2·N·D floats more of workspace),
  the ring carrying h's hi and lo boxes beside W's (64 KB stages, 3 of
  them), no split in registers; held to the limits;
- one part out at a time (wrong values, read for their time):
  ``fwd_no_tma_load``, ``fwd_no_a_split``, ``fwd_no_epilogue`` (no fold:
  the logits tile summed into two floats, so that no step's sums are
  dead), ``fwd_no_wgmma``.

With ``--parent FILE`` (a ``fused_ce.cu`` of another version; without
it, ``git show HEAD~1:bigdl_tpu_torch/csrc/fused_ce.cu`` where the
checkout is a git repository), it then builds that version too (in the
temporary directory, against this checkout's headers) and reads both in
turns (this, parent, parent, this): the f32 forward (the parent's own
kernel: before this route, the CUDA-core one), the f32 dh and dW/db and
the three bf16 kernels, whose outputs must be bit-equal to the parent's;
then the harness step ``perf -m transformer --dataType f32`` at
``chip_smoke._PERF``'s geometry (1 warm-up, 3 timed steps) with each
version's kernels, in the same turns.

``--only chunked`` instead reads the bf16 dh and dW/db past D 1024
(route "tc_chunked": ``fce_dl_tc_kernel`` writes a chunk of resident
rows' dl, ``fce_gemm_tc_kernel`` multiplies it by the walked operand) at
``chip_smoke._FCE_WIDE_BWD`` (N 8192, V 32768, D 2048), each version's
outputs held against the plain versions at ``chip_smoke``'s limits
(``CHUNKED_VERSIONS``' third field: the knockouts' are printed, held to
nothing), then timed in turns (the versions in order, then in reverse):

- ``no_pass1``, ``no_pass2``: one pass not launched, the other timed
  alone (pass 2 then reads a stale chunk; dW's db merge stays with pass
  1's time);
- ``no_dl_store``: pass 1 forms dl but stores none, so its time less
  the kept one's is what the direct stores from the accumulator cost,
  and the most a staged TMA store could save;
- ``no_dl_epilogue``: pass 1 stores the logits as dl (no exp, no column
  values, no one-hot);
- ``pass1_no_tma_load``, ``pass2_no_tma_load``: one pass's producer
  completes each ring stage's barrier without loading (its products
  without the L2 traffic into the ring; the other pass as kept);
- ``budget_64``, ``budget_32``: the workspace's ``kChunkBytes`` at 64
  and 32 MiB (more, smaller chunks), held to the limits.

Then the harness head's D 1024, which the cluster kernels take: the
kept dh and dW/db (route "tc_cluster") against a copy that sends bf16
past D 0 to the chunked passes (``chunked_d1024``, held to the limits),
in turns. With ``--parent FILE`` (as ``--only tf32`` takes it), last
the A/B in turns against the parent: the D 2048 pair (the parent's own
kernels: before this route, the CUDA-core ``fce_bwd_kernel<bf16>``),
then at the harness head the bf16 forward, dh and dW/db and the f32
forward, dh and dW/db, which must be bit-equal to the parent's.

    python3 scripts/fused_ce_knockout.py [--seed N]
    python3 scripts/fused_ce_knockout.py --only tf32 [--parent FILE]
    python3 scripts/fused_ce_knockout.py --only chunked [--parent FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import flash_sliced_knockout  # noqa: E402
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


def _knocked_out(src: str, name: str, kernels, edits) -> str:
    """``src`` with a knockout's edits: each (text, replacement, count),
    within the body of the kernel it knocks a part out of
    (``fce_fwd_tc_kernel`` or ``fce_bwd_tc_kernel``) where the text lies
    there (the chunked backward's kernels repeat the forward's producer
    and products), else in the whole source; a text found another number
    of times raises."""
    text = src
    kernel = "fce_fwd_tc_kernel" if kernels == ("fwd",) else \
        "fce_bwd_tc_kernel"
    for old, new, count in edits:
        a, z = 0, len(text)
        start = text.index(f"\n{kernel}(")
        end = text.index("\n}\n", start) + 3
        if old in text[start:end]:
            a, z = start, end
        if text[a:z].count(old) != count:
            raise RuntimeError(f"{name}: the text it knocks out has moved; "
                               f"update the knockouts")
        text = text[:a] + text[a:z].replace(old, new) + text[z:]
    return text


def _fault_source(src: str, where: str) -> str:
    return src.replace(_STAGE_LINE, (
        "      const uint32_t hs = ring.base + st * kFwdStage;\n"
        f"      const uint32_t ws = i >= 1 && {where} ? {_PREV} : "
        "hs + kHBox;\n"))


#: the f32 3xTF32 backward's knockouts (``--only tf32``): name -> (what it
#: undoes, [(text, its replacement)], held to the limits)
TF32_KNOCKOUTS = {
    name: (flash_sliced_knockout.TF32_VARIANTS[name][1],
           flash_sliced_knockout.TF32_VARIANTS[name][2], False)
    for name in ("chained_score", "chained_out")}
TF32_KNOCKOUTS["recompute_per_slice"] = (
    "each CTA of a cluster forms the logits over all of D (a 512-column "
    "output slice each, the logits recomputed by both), no exchange",
    [("  const int nh = ((D + 31) / 32 + 2 * kRanks - 1) / (2 * kRanks);\n"
      "  const int sc0 = 2 * nh * rank;",
      "  const int nh = ((D + 31) / 32 + 1) / 2;\n  const int sc0 = 0;"),
     ("        exchange(s, recv, xfull, xempty, rank, i);\n", ""),
     ("    if constexpr (G == 0) drain(xempty, nxt);\n", "")], True)
# what sets the pace: one part taken out at a time (wrong values, read
# for their time alone)
TF32_KNOCKOUTS.update({
    "no_tma_load": (
        "the producer completes each stage's barrier without loading: no "
        "L2 traffic into the ring (the split pass still runs)",
        [("          const uint32_t dst = ring.acquire(t, kTfStage);\n"
          "          for (int w = 0; w < 2; ++w) {\n"
          "            const int c = 32 * (sc0 + nh * w + j);\n"
          "            tma_load_2d(dst + 2 * w * kTfBox, &rm, ring.full(), "
          "c, r0);\n"
          "            tma_load_2d(dst + (2 * w + 1) * kTfBox, &xhm, "
          "ring.full(), c,\n                        x0);\n"
          "            tma_load_2d(dst + (4 + w) * kTfBox, &xlm, ring.full(), "
          "c, x0);\n          }\n",
          "          ring.acquire(t, 0);\n"),
         ("          const uint32_t dst = ring.acquire(t, (two ? 4 : 2) * "
          "kTfBox);\n"
          "          for (int w = 0; w < (two ? 2 : 1); ++w)\n"
          "            for (int e = 0; e < 2; ++e)\n"
          "              tma_load_2d(dst + (2 * w + e) * kTfBox, &xm, "
          "ring.full(),\n"
          "                          64 * (ch0 + own0 * w + p) + 32 * e, "
          "x0);\n",
          "          ring.acquire(t, 0);\n")], False),
    "no_a_split": (
        "A's raw f32 taken as both tf32 parts, not split in registers (the "
        "shared-memory loads stay)",
        [("// One score step: s (+)= A·Bᵀ over 32 columns",
          "__device__ __forceinline__ void no_split(float x, uint32_t& hi,\n"
          "                                         uint32_t& lo) {\n"
          "  hi = lo = __float_as_uint(x);\n}\n\n"
          "// One score step: s (+)= A·Bᵀ over 32 columns"),
         ("        split_tf32(ld_shared(a_t + tf_at(r0 + 8 * (e & 1),",
          "        no_split(ld_shared(a_t + tf_at(r0 + 8 * (e & 1),"),
         ("        split_tf32(ld_shared(a_t + tf_at(32 * half + 8 * kk + t +",
          "        no_split(ld_shared(a_t + tf_at(32 * half + 8 * kk + t +")],
        False),
    "no_exchange": (
        "no exchange through distributed shared memory: each CTA forms dl "
        "from its own half of the logits",
        [("        exchange(s, recv, xfull, xempty, rank, i);\n", ""),
         ("    if constexpr (G == 0) drain(xempty, nxt);\n", "")], False),
    "no_dl": (
        "no dl formed (no column values read, no exp): the logits pass as "
        "dl",
        [("            float d = 0.f;\n"
          "            if (rok[h] && x0 + c + u < nX)\n",
          "            float d = s[e];\n            if (false)\n")], False),
    "no_score_wgmma": (
        "no wgmma in the score steps (A still split, the fresh sums still "
        "waited for and added)",
        [("      wgmma_tf32_rs_n64(acc, ah[kk], desc(blo + k), kk > 0);\n"
          "      wgmma_tf32_rs_n64(acc, al[kk], desc(b_t + k), 1);\n", ""),
         ("      wgmma_tf32_rs_n64(acc, ah[kk], desc(b_t + 32 * (k0 + kk)), "
          "1);\n", "      ;\n")], False),
    "no_out_wgmma": (
        "no wgmma in the output steps (A still split, the fresh sums still "
        "waited for and added)",
        [("      wgmma_tf32_rs_n64(d, ah[kk], desc(blo + k), kk > 0);\n"
          "      wgmma_tf32_rs_n64(d, al[kk], desc(bhi + k), 1);\n"
          "      wgmma_tf32_rs_n64(d, ah[kk], desc(bhi + k), 1);\n", "")],
        False),
})

#: the f32 3xTF32 forward's versions: name -> (what it changes, [(text,
#: its replacement)], held to the limits, extra workspace floats at (N,
#: D))
_FWD_A_SPLIT = ("      split_tf32(ld_shared(a_t + tf_at(r0 + 8 * (e & 1),\n"
                "                                       8 * kk + t + 4 * "
                "(e >> 1))),\n                 ah[kk][e], al[kk][e]);\n")
_FWD_LOADS = ("          const uint32_t dst = ring.acquire(t, kFwdStage);\n"
              "          tma_load_2d(dst, &hm, ring.full(), 32 * j, r0);\n"
              "          tma_load_2d(dst + kFwdWHi, &whm, ring.full(), "
              "32 * j, v0);\n"
              "          tma_load_2d(dst + kFwdWLo, &wlm, ring.full(), "
              "32 * j, v0);\n")
TF32_FWD_KNOCKOUTS = {
    "fwd_chained_score": (
        "the score products summed in one tensor-core chain over all of a "
        "tile's D (no fresh sum a score step)",
        [("  float acc[64];\n  wg_fence();",
          "  float (&acc)[64] = s;\n  wg_fence();"),
         ("    wgmma_tf32_rs_n128(acc, ah[kk], desc(blo + 32 * kk), kk > 0);",
          "    wgmma_tf32_rs_n128(acc, ah[kk], desc(blo + 32 * kk), 1);"),
         ("#pragma unroll\n  for (int e = 0; e < 64; ++e) s[e] += acc[e];\n",
          "")], False, 0),
    "fwd_select_first_step": (
        "the design not kept for the logits tile: not zeroed at a tile's "
        "start but set from the first step's sum, a select in every step",
        [("                                               uint32_t b_t, "
          "uint32_t blo) {",
          "                                               uint32_t b_t, "
          "uint32_t blo, bool first) {"),
         ("      fwd_score_step(s, st + wg * kTfBox, st + kFwdWHi, "
          "st + kFwdWLo);",
          "      fwd_score_step(s, st + wg * kTfBox, st + kFwdWHi, "
          "st + kFwdWLo, j == 0);"),
         ("  for (int e = 0; e < 64; ++e) s[e] += acc[e];",
          "  for (int e = 0; e < 64; ++e) s[e] = first ? acc[e] : s[e] + "
          "acc[e];"),
         ("    tc::load_bias(bias, b, V, v0, c0);\n    zero(s);\n",
          "    tc::load_bias(bias, b, V, v0, c0);\n")], True, 0),
    "fwd_a_parts_split_pass": (
        "h's tf32 parts from a second split pass: the ring carries h's hi "
        "and lo boxes beside W's (64 KB stages, 3), no split in registers",
        [("constexpr int kFwdStages = 4;         // ring stages",
          "constexpr int kFwdStages = 3;         // ring stages"),
         ("constexpr int kFwdWHi = 2 * kTfBox, kFwdWLo = 4 * kTfBox;\n"
          "constexpr int kFwdStage = kTfStage;",
          "constexpr int kFwdWHi = 4 * kTfBox, kFwdWLo = 6 * kTfBox;\n"
          "constexpr int kFwdStage = 8 * kTfBox;"),
         # the ring's stages are kTfStage apart; these are kFwdStage
         ("          const uint32_t dst = ring.acquire(t, kFwdStage);\n",
          "          ring.acquire(t, kFwdStage);\n"
          "          const uint32_t dst = base + ring.st * kFwdStage;\n"),
         ("      const uint32_t st = ring.wait();\n"
          "      fwd_score_step(",
          "      ring.wait();\n"
          "      const uint32_t st = base + ring.st * kFwdStage;\n"
          "      fwd_score_step("),
         ("fce_fwd_tf32_kernel(const __grid_constant__ CUtensorMap hm,\n",
          "fce_fwd_tf32_kernel(const __grid_constant__ CUtensorMap hm,\n"
          "                    const __grid_constant__ CUtensorMap hlm,\n"),
         ("          tma_load_2d(dst, &hm, ring.full(), 32 * j, r0);\n",
          "          tma_load_2d(dst, &hm, ring.full(), 32 * j, r0);\n"
          "          tma_load_2d(dst + 2 * kTfBox, &hlm, ring.full(), 32 * j, "
          "r0);\n"),
         (_FWD_A_SPLIT,
          "      {\n        const uint32_t off = tf_at(r0 + 8 * (e & 1), "
          "8 * kk + t + 4 * (e >> 1));\n"
          "        ah[kk][e] = __float_as_uint(ld_shared(a_t + off));\n"
          "        al[kk][e] = __float_as_uint(ld_shared(a_t + 2 * kTfBox + "
          "off));\n      }\n"),
         ("  if (int e = split_pass(w, work, n, st)) return e;\n"
          "  CUtensorMap hm, whm, wlm;\n"
          "  if (int e = make_map(&hm, h, N, D, kFwdRows, true)) return e;\n",
          "  if (int e = split_pass(w, work, n, st)) return e;\n"
          "  const int64_t nh = static_cast<int64_t>(N) * D;\n"
          "  if (int e = split_pass(h, work + 2 * n, nh, st)) return e;\n"
          "  CUtensorMap hm, hlm, whm, wlm;\n"
          "  if (int e = make_map(&hm, work + 2 * n, N, D, kFwdRows, true)) "
          "return e;\n"
          "  if (int e = make_map(&hlm, work + 2 * n + nh, N, D, kFwdRows, "
          "true)) return e;\n"),
         ("(hm, whm, wlm, b, t, part,", "(hm, hlm, whm, wlm, b, t, part,")],
        True, 2),
    "fwd_no_tma_load": (
        "the producer completes each stage's barrier without loading: no "
        "L2 traffic into the ring (the split pass still runs)",
        [(_FWD_LOADS, "          ring.acquire(t, 0);\n")], False, 0),
    "fwd_no_a_split": (
        "h's raw f32 taken as both tf32 parts, not split in registers (the "
        "shared-memory loads stay)",
        [("// One score step of the forward:",
          "__device__ __forceinline__ void no_split(float x, uint32_t& hi,\n"
          "                                         uint32_t& lo) {\n"
          "  hi = lo = __float_as_uint(x);\n}\n\n"
          "// One score step of the forward:"),
         (_FWD_A_SPLIT, _FWD_A_SPLIT.replace("split_tf32(", "no_split(")
          .replace("\n                 ah", "\n               ah"))],
        False, 0),
    "fwd_no_epilogue": (
        "no fold (bias, mask, target, max, ex2): the logits tile summed "
        "into two floats instead",
        [("    tc::fold(s, bias, c0, tcol, m, ls, tl);\n",
          "    for (int e = 0; e < 64; ++e) ls[e & 1] += s[e];\n")],
        False, 0),
    "fwd_no_wgmma": (
        "no wgmma in the score steps (A still split, the fresh sums still "
        "waited for and added)",
        [("    wgmma_tf32_rs_n128(acc, ah[kk], desc(blo + 32 * kk), kk > 0);\n"
          "    wgmma_tf32_rs_n128(acc, al[kk], desc(b_t + 32 * kk), 1);\n",
          ""),
         ("    wgmma_tf32_rs_n128(acc, ah[kk], desc(b_t + 32 * kk), 1);\n",
          "    ;\n")], False, 0),
}
_ORDER = ("this", "parent", "parent", "this")

#: the bf16 chunked backward's versions (``--only chunked``): name ->
#: (what it changes, [(text, its replacement)], held to the limits)
_PASS1 = ("    pass1<<<dim3(rtiles, vocab_splits(rows, nX, kFwdRows, "
          "kFwdCols, sms)),\n            kFwdThreads, kDlSmem, st>>>(rm, xm, "
          "b, t, lse, g, dl, dbp, r0,\n" + " " * 40
          + "rows, nR, nX, nXp, D);\n")
_PASS2 = ("    fce_gemm_tc_kernel<<<dim3((D + kFwdCols - 1) / kFwdCols, "
          "rtiles),\n                         kFwdThreads, FwdLayout::kSmem, "
          "st>>>(\n        am, bm, static_cast<bf16*>(out) + "
          "static_cast<int64_t>(r0) * D, rows,\n        nX, D);\n")
_DL_STORE = "        if (rok[h] && x < nX)\n"
_DL_FORMULA = "\n".join((
    "          d[e] = kVocabRows",
    "                     ? (ex2(fmaf(sv + rv[h], kLog2e, -cvv)) -",
    "                        ((e ? ct.y : ct.x) == r ? 1.f : 0.f)) *",
    "                           (e ? cg.y : cg.x)",
    "                     : (ex2(fmaf(sv + cvv, kLog2e, -rv[h])) -",
    "                        (x + e == rcol[h] ? 1.f : 0.f)) * rg[h];", ""))
_BUDGET = "constexpr int64_t kChunkBytes = 128ll << 20;"
CHUNKED_VERSIONS = {
    "no_pass1": ("pass 1 not launched: pass 2 alone, on a stale chunk",
                 [(_PASS1, "")], False),
    "no_pass2": ("pass 2 not launched: pass 1 (and dW's db merge) alone",
                 [(_PASS2, "")], False),
    "no_dl_store": (
        "pass 1 forms dl but stores none (a never-true test keeps dl "
        "live): the direct stores' cost",
        [(_DL_STORE, "        if (__float_as_uint(d[0]) == 0xffffffffu)\n")],
        False),
    "no_dl_epilogue": (
        "pass 1 stores the logits as dl: no exp, no column values, no "
        "one-hot", [(_DL_FORMULA, "          d[e] = sv;\n")], False),
    "pass1_no_tma_load": (
        "pass 1's producer completes each stage's barrier without loading: "
        "its products and epilogue without the L2 traffic into the ring",
        [("        bar_expect(ring.full(st), kFwdStage);\n"
          "        tma_load_2d(dst, &rm, ring.full(st), d0, rt);\n"
          "        tma_load_2d(dst + kHBox, &xm, ring.full(st), d0,\n"
          "                    (t0 + i / nb) * kFwdCols);\n",
          "        bar_arrive(ring.full(st));\n")], False),
    "pass2_no_tma_load": (
        "pass 2's producer completes each stage's barrier without loading",
        [("        bar_expect(ring.full(st), kHBox + nc * 64 * kRowBytes);\n"
          "        tma_load_2d(dst, &am, ring.full(st), 64 * i, r0);\n"
          "        for (int c = 0; c < nc; ++c)\n"
          "          tma_load_2d(dst + kHBox + c * 64 * kRowBytes, &bm, "
          "ring.full(st),\n                      d0 + 64 * c, 64 * i);\n",
          "        bar_arrive(ring.full(st));\n")], False),
    "budget_64": ("a workspace of 64 MiB: smaller chunks, twice as many",
                  [(_BUDGET, _BUDGET.replace("128ll", "64ll"))], True),
    "budget_32": ("a workspace of 32 MiB: four times the chunks",
                  [(_BUDGET, _BUDGET.replace("128ll", "32ll"))], True),
}
#: the copy that sends bf16 at every D to the chunked passes
_CLUSTERED = "  return sizeof(T) == 2 && D <= kClusterD;"


def _f64_backward(h, w, b, t, lse, g):
    """dh, dW and db of the function evaluated in float64 from the same
    inputs (the plain forward's lse among them)."""
    h64, w64 = h.double(), w.double()
    s = h64 @ w64.T + b.double()
    dl = torch.exp(s - lse.double()[:, None])
    rows = torch.arange(h.shape[0], device=h.device)
    ok = (t >= 1) & (t <= w.shape[0])
    dl[rows[ok], (t[ok] - 1).long()] -= 1.0
    dl *= g.double()[:, None]
    return dl @ w64, dl.T @ h64, dl.sum(dim=0)


def _f64_forward(h, w, b, t):
    """nll and lse of the function evaluated in float64 from the same
    inputs."""
    s = h.double() @ w.double().T + b.double()
    lse = torch.logsumexp(s, dim=1)
    t0 = t.long() - 1
    ok = (t0 >= 0) & (t0 < w.shape[0])
    tl = torch.where(ok, s.gather(1, t0.clamp(0, w.shape[0] - 1)[:, None])
                     [:, 0], 0.0)
    return (lse - tl).float(), lse.float()


def _held(got, plain, exact, lim):
    """Max abs error against the plain version, and the worst error /
    limit against it and against the float64 function."""
    err, worst = chip_smoke._worst(got, plain, *lim)
    return {"max_abs_err": err, "over_limit": worst,
            "over_limit_f64": chip_smoke._worst(got, exact, *lim)[1]}


def _parent_source(path):
    """The other version's fused_ce.cu: ``path``, or HEAD~1's."""
    if path:
        return Path(path).read_text()
    return subprocess.run(
        ["git", "show", "HEAD~1:bigdl_tpu_torch/csrc/fused_ce.cu"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout


def _edited(src, edits, name, failed):
    """``src`` with each (text, replacement) of ``edits`` applied; a text
    that is not in ``src`` exactly once goes into ``failed``."""
    for old, new in edits:
        if src.count(old) != 1:
            failed.append(f"{name}: {old.strip()[:60]!r} moved")
        src = src.replace(old, new)
    return src


def _tf32(args) -> int:
    """``--only tf32``: the knockouts of the forward and the backward,
    then the A/B against the parent."""
    src = _build.inline_header(
        (ROOT / "bigdl_tpu_torch/csrc/fused_ce.cu").read_text(), "tf32.cuh")
    sources, failed = {"as_is": src}, []
    kernels = {"as_is": ("fwd", "dh", "dw")}
    for name, (what, edits, _) in TF32_KNOCKOUTS.items():
        sources[name] = _edited(src, edits, name, failed)
        kernels[name] = ("dh", "dw")
        print(f"[knockout] {name}: {what}", flush=True)
    for name, (what, edits, _, _) in TF32_FWD_KNOCKOUTS.items():
        sources[name] = _edited(src, edits, name, failed)
        kernels[name] = ("fwd",)
        print(f"[knockout] {name}: {what}", flush=True)
    parent = _parent_source(args.parent) if args.compare else None
    if parent is not None:
        sources["parent"] = parent
    card = chip_smoke._card()
    gen = torch.Generator().manual_seed(args.seed)
    n, v, d = 8192, 32768, 1024
    h, w, b, t, g = chip_smoke._fce_inputs(n, v, d, torch.float32, gen,
                                           False)
    pnll, lse = fce.fused_ce_fwd_ref(h, w, b, t)
    plain = {"nll": pnll, "lse": lse,
             "dh": fce.fused_ce_dh_ref(h, w, b, t, lse, g)}
    plain["dw"], plain["db"] = fce.fused_ce_dw_ref(h, w, b, t, lse, g)
    exact = dict(zip(("nll", "lse"), _f64_forward(h, w, b, t)))
    exact.update(zip(("dh", "dw", "db"), _f64_backward(h, w, b, t, lse, g)))
    torch.cuda.empty_cache()
    lims = {k: (None, chip_smoke._FCE_ABS_TOL) for k in ("nll", "lse")}
    lims.update(dh=chip_smoke._FCE_TOL[torch.float32],
                dw=chip_smoke._FCE_TOL[torch.float32],
                db=chip_smoke._FCE_DB_TOL)
    calls = {"fwd": lambda: fce.fused_ce_fwd(h, w, b, t),
             "dh": lambda: fce.fused_ce_dh(h, w, b, t, lse, g),
             "dw": lambda: fce.fused_ce_dw(h, w, b, t, lse, g)}
    outputs = {"fwd": ("nll", "lse"), "dh": ("dh",), "dw": ("dw", "db")}
    chosen, floats = fce._kernel_fns, fce.workspace_floats

    def use(name):
        """This process's fused-CE calls on version ``name``'s library,
        with the workspace it needs."""
        fce._kernel_fns = lambda f=fns[name]: f
        more = (TF32_FWD_KNOCKOUTS[name][3] if name in TF32_FWD_KNOCKOUTS
                else 0)
        fce.workspace_floats = (
            lambda k, n_, v_, d_, dt: floats(k, n_, v_, d_, dt)
            + (more * n_ * d_ if k == "fwd" else 0))

    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            fns = dict(zip(sources, pool.map(
                lambda kv: fce.bind(_build.build_copy(kv[1],
                                                      Path(tmp) / kv[0])),
                sources.items())))
        try:
            chip_smoke._warm_card()
            names = [k for k in sources if k != "parent"]
            times = {k: {c: [] for c in kernels[k]} for k in names}
            for name in names:
                use(name)
                row = {}
                for c in kernels[name]:
                    got = calls[c]()
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    for what, x in zip(outputs[c], got):
                        row[what] = _held(x, plain[what], exact[what],
                                          lims[what])
                    del got
                held = (name == "as_is" or name in TF32_KNOCKOUTS
                        and TF32_KNOCKOUTS[name][2]
                        or name in TF32_FWD_KNOCKOUTS
                        and TF32_FWD_KNOCKOUTS[name][2])
                bad = [k for k, r in row.items() if not r["over_limit"] <= 1]
                if held and bad:
                    failed.append(f"{name}: {bad} past the limit")
                print(f"[tf32] {name} N={n} V={v} D={d} f32 errors "
                      + json.dumps(row) + (" (held to the limits)" if held
                                           else " (held to nothing)"),
                      flush=True)
            for name in names + names[::-1]:
                use(name)
                for c in kernels[name]:
                    times[name][c].append(chip_smoke._time_ms(calls[c]))
            for name in names:
                ms = {k: sum(x) / len(x) for k, x in times[name].items()}
                ratio = {k: ms[k] / (sum(times["as_is"][k])
                                     / len(times["as_is"][k]))
                         for k in ms}
                print(f"[knockout] card='{card}' N={n} V={v} D={d} f32 "
                      f"{name}: ms " + json.dumps(times[name]) + " mean "
                      + json.dumps(ms) + " ratio to as_is "
                      + json.dumps(ratio), flush=True)
            fce.workspace_floats = floats
            if parent is not None:
                failed += _against_parent(fns, gen, card)
        finally:
            fce._kernel_fns, fce.workspace_floats = chosen, floats
    if failed:
        print("[knockout] failed: " + "; ".join(failed), flush=True)
    print(card)
    return 1 if failed else 0


def _against_parent(fns, gen, card, rebuilt=(("fwd", torch.float32),),
                    step=True):
    """This version against the parent in turns: the f32 and bf16
    forward, dh and dW/db at the harness head, each bit-equal to the
    parent's but those ``rebuilt`` ((kernel, dtype) pairs: by default the
    f32 forward), then, with ``step``, the f32 harness step. Returns what
    failed."""
    from bigdl_tpu_torch.models.utils import perf
    n, v, d = 8192, 32768, 1024
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        h, w, b, t, g = chip_smoke._fce_inputs(n, v, d, dtype, gen, False)
        _, lse = fce.fused_ce_fwd_ref(h, w, b, t)
        calls = {"fwd": lambda: fce.fused_ce_fwd(h, w, b, t),
                 "dh": lambda: fce.fused_ce_dh(h, w, b, t, lse, g),
                 "dw": lambda: fce.fused_ce_dw(h, w, b, t, lse, g)}
        outs, ms = {}, {k: {"this": [], "parent": []} for k in calls}
        for ver in _ORDER:
            fce._kernel_fns = lambda f=fns["as_is" if ver == "this"
                                         else "parent"]: f
            for k, call in calls.items():
                if ver not in outs.get(k, {}):
                    out = call()
                    torch.cuda.synchronize()
                    outs.setdefault(k, {})[ver] = out
                ms[k][ver].append(chip_smoke._time_ms(call))
        for k in calls:
            a, p = outs[k]["this"], outs[k]["parent"]
            a, p = (a, p) if isinstance(a, tuple) else ((a,), (p,))
            equal = all(torch.equal(x, y) for x, y in zip(a, p))
            mean = {ver: sum(x) / len(x) for ver, x in ms[k].items()}
            if not equal and (k, dtype) not in rebuilt:
                failed.append(f"{k} {name}: not bit-equal to the parent")
            print(f"[parent] card='{card}' fused_ce_{k} {name} N={n} V={v} "
                  f"D={d}: route {fce.kernel_route(dtype, d, k)!r} ms "
                  + json.dumps(ms[k]) + " mean " + json.dumps(mean)
                  + f" this/parent {mean['this'] / mean['parent']} "
                  f"bit_equal={equal}", flush=True)
        del h, w, b, t, g, lse, outs
        torch.cuda.empty_cache()
    if not step:
        return failed
    p = chip_smoke._PERF
    argv = chip_smoke._perf_args(warm_up=1, iterations=3) + [
        "--dataType", "f32"]
    steps = {"this": [], "parent": []}
    for ver in _ORDER:
        fce._kernel_fns = lambda f=fns["as_is" if ver == "this"
                                     else "parent"]: f
        out = perf.main(argv)
        steps[ver].append(out["ms_per_step"])
        print(f"[parent] card='{card}' perf -m transformer --dataType f32 "
              f"B{p['batch']} S{p['seq']} V{p['vocab']} d{p['d_model']} "
              f"L{p['layers']} {ver}: ms_per_step={out['ms_per_step']} "
              f"peak_bytes={out['peak_bytes']} first_loss="
              f"{out['first_loss']}", flush=True)
        del out
        torch.cuda.empty_cache()
    mean = {ver: sum(x) / len(x) for ver, x in steps.items()}
    print(f"[parent] card='{card}' f32 step ms " + json.dumps(steps)
          + " mean " + json.dumps(mean) + f" this - parent "
          f"{mean['this'] - mean['parent']}", flush=True)
    return failed


def _in_turns(names, calls, use):
    """Device ms of each of ``calls`` (name -> call) on each version of
    ``names``, timed with ``use(version)`` in force, the versions in
    order and then in reverse: version -> call -> [ms, ms]."""
    times = {k: {c: [] for c in calls} for k in names}
    for name in list(names) + list(names)[::-1]:
        use(name)
        for c, call in calls.items():
            times[name][c].append(chip_smoke._time_ms(call))
    return times


def _chunked_rows(label, times, base, card, shape):
    """Print each version's times, their means and the ratio of each
    mean to ``base``'s."""
    n, v, d = shape
    mean = {k: {c: sum(x) / len(x) for c, x in r.items()}
            for k, r in times.items()}
    for name, ms in mean.items():
        print(f"[{label}] card='{card}' N={n} V={v} D={d} bf16 {name}: ms "
              + json.dumps(times[name]) + " mean " + json.dumps(ms)
              + f" ratio to {base} " + json.dumps(
                  {c: ms[c] / mean[base][c] for c in ms})
              + f" pair {ms['dh'] + ms['dw']}", flush=True)


def _chunked(args) -> int:
    """``--only chunked``: the chunked backward's knockouts at D 2048,
    the D 1024 reading against the cluster kernels, then the A/B against
    the parent."""
    src = (ROOT / "bigdl_tpu_torch/csrc/fused_ce.cu").read_text()
    sources, failed = {"as_is": src}, []
    for name, (what, edits, _) in CHUNKED_VERSIONS.items():
        sources[name] = _edited(src, edits, name, failed)
        print(f"[knockout] {name}: {what}", flush=True)
    sources["chunked_d1024"] = _edited(
        src, [(_CLUSTERED, "  return sizeof(T) == 2 && D < 0;")],
        "chunked_d1024", failed)
    if args.compare:
        sources["parent"] = _parent_source(args.parent)
    card = chip_smoke._card()
    gen = torch.Generator().manual_seed(args.seed)
    chosen, cluster_d = fce._kernel_fns, fce._CLUSTER_D
    lims = {"dh": chip_smoke._FCE_TOL[torch.bfloat16],
            "dw": chip_smoke._FCE_TOL[torch.bfloat16],
            "db": chip_smoke._FCE_DB_TOL}

    def use(name):
        fce._kernel_fns = lambda f=fns[name]: f

    def held_rows(names, h, w, b, t, g, lse, held, shape):
        """Each version's dh, dW and db against the plain versions."""
        plain = {"dh": fce.fused_ce_dh_ref(h, w, b, t, lse, g)}
        plain["dw"], plain["db"] = fce.fused_ce_dw_ref(h, w, b, t, lse, g)
        for name in names:
            use(name)
            got = {"dh": fce.fused_ce_dh(h, w, b, t, lse, g)}
            got["dw"], got["db"] = fce.fused_ce_dw(h, w, b, t, lse, g)
            torch.cuda.synchronize()
            row = {k: chip_smoke._worst(got[k], plain[k], *lims[k])
                   for k in got}
            bad = [k for k, (_, r) in row.items()
                   if not (r <= 1 and torch.isfinite(got[k]).all())]
            if held(name) and bad:
                failed.append(f"{name} at {shape}: {bad} past the limit")
            print(f"[chunked] {name} N, V, D = {shape} bf16 (max abs err, "
                  f"worst error / limit) " + json.dumps(row)
                  + (" (held to the limits)" if held(name)
                     else " (held to nothing)"), flush=True)
            del got

    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(sources)) as pool:
            fns = dict(zip(sources, pool.map(
                lambda kv: fce.bind(_build.build_copy(kv[1],
                                                      Path(tmp) / kv[0])),
                sources.items())))
        try:
            chip_smoke._warm_card()
            shape = chip_smoke._FCE_WIDE_BWD[1:]
            h, w, b, t, g = chip_smoke._fce_inputs(*shape, torch.bfloat16,
                                                   gen, False)
            _, lse = fce.fused_ce_fwd_ref(h, w, b, t)
            names = ["as_is", *CHUNKED_VERSIONS]
            held_rows(names, h, w, b, t, g, lse,
                      lambda k: k == "as_is" or CHUNKED_VERSIONS[k][2], shape)
            calls = {"dh": lambda: fce.fused_ce_dh(h, w, b, t, lse, g),
                     "dw": lambda: fce.fused_ce_dw(h, w, b, t, lse, g)}
            _chunked_rows("knockout", _in_turns(names, calls, use), "as_is",
                          card, shape)
            del h, w, b, t, g, lse, calls
            torch.cuda.empty_cache()

            # D 1024: the cluster kernels (as_is) against the chunked passes
            # (_CLUSTER_D 0: the route, its workspace and its counters)
            shape = (8192, 32768, 1024)
            h, w, b, t, g = chip_smoke._fce_inputs(*shape, torch.bfloat16,
                                                   gen, False)
            _, lse = fce.fused_ce_fwd_ref(h, w, b, t)

            def at_1024(name):
                use(name)
                fce._CLUSTER_D = 0 if name == "chunked_d1024" else cluster_d

            calls = {"dh": lambda: fce.fused_ce_dh(h, w, b, t, lse, g),
                     "dw": lambda: fce.fused_ce_dw(h, w, b, t, lse, g)}
            fce._CLUSTER_D = 0
            held_rows(["chunked_d1024"], h, w, b, t, g, lse, lambda k: True,
                      shape)
            times = _in_turns(["as_is", "chunked_d1024"], calls, at_1024)
            fce._CLUSTER_D = cluster_d
            _chunked_rows("d1024", times, "as_is", card, shape)
            del h, w, b, t, g, lse, calls
            torch.cuda.empty_cache()

            if args.compare:
                failed += _chunked_against_parent(fns, gen, card)
        finally:
            fce._kernel_fns, fce._CLUSTER_D = chosen, cluster_d
    if failed:
        print("[knockout] failed: " + "; ".join(failed), flush=True)
    print(card)
    return 1 if failed else 0


def _chunked_against_parent(fns, gen, card):
    """The D 2048 pair against the parent's in turns (this, parent,
    parent, this; each version's outputs held to the limits), then
    ``_against_parent``'s kernels at the harness head, every one
    bit-equal. Returns what failed."""
    shape = chip_smoke._FCE_WIDE_BWD[1:]
    h, w, b, t, g = chip_smoke._fce_inputs(*shape, torch.bfloat16, gen,
                                           False)
    _, lse = fce.fused_ce_fwd_ref(h, w, b, t)
    plain = {"dh": fce.fused_ce_dh_ref(h, w, b, t, lse, g)}
    plain["dw"], plain["db"] = fce.fused_ce_dw_ref(h, w, b, t, lse, g)
    calls = {"dh": lambda: fce.fused_ce_dh(h, w, b, t, lse, g),
             "dw": lambda: fce.fused_ce_dw(h, w, b, t, lse, g)}
    failed, ms = [], {k: {"this": [], "parent": []} for k in calls}
    for ver in _ORDER:
        fce._kernel_fns = lambda f=fns["as_is" if ver == "this"
                                     else "parent"]: f
        if not ms["dh"][ver]:
            got = {"dh": calls["dh"]()}
            got["dw"], got["db"] = calls["dw"]()
            torch.cuda.synchronize()
            lim = {"dh": chip_smoke._FCE_TOL[torch.bfloat16],
                   "dw": chip_smoke._FCE_TOL[torch.bfloat16],
                   "db": chip_smoke._FCE_DB_TOL}
            row = {k: chip_smoke._worst(got[k], plain[k], *lim[k])
                   for k in got}
            if any(r > 1 for _, r in row.values()):
                failed.append(f"{ver} at D 2048: past the limit")
            print(f"[parent] {ver} N, V, D = {shape} bf16 (max abs err, "
                  f"worst error / limit) " + json.dumps(row), flush=True)
            del got
        for k, call in calls.items():
            ms[k][ver].append(chip_smoke._time_ms(call))
    for k in calls:
        mean = {ver: sum(x) / len(x) for ver, x in ms[k].items()}
        print(f"[parent] card='{card}' fused_ce_{k} bf16 N, V, D = {shape}: "
              f"ms " + json.dumps(ms[k]) + " mean " + json.dumps(mean)
              + f" parent/this {mean['parent'] / mean['this']}", flush=True)
    del h, w, b, t, g, lse, plain, calls
    torch.cuda.empty_cache()
    return failed + _against_parent(fns, gen, card, rebuilt=(), step=False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("bf16", "tf32", "chunked"),
                    default="bf16",
                    help="the bf16 kernels' knockouts and faults, the f32 "
                    "3xTF32 kernels' knockouts and A/B, or the bf16 "
                    "chunked backward's knockouts and A/B")
    ap.add_argument("--parent", default=None,
                    help="the fused_ce.cu to hold --only tf32 or chunked "
                    "against (default: HEAD~1's, from git)")
    ap.add_argument("--no-parent", dest="compare", action="store_false",
                    help="--only tf32 or chunked without the A/B against "
                    "the parent")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ce_knockout: CUDA is not available", file=sys.stderr)
        return 2
    if args.only == "tf32":
        return _tf32(args)
    if args.only == "chunked":
        return _chunked(args)
    src = (ROOT / "bigdl_tpu_torch/csrc/fused_ce.cu").read_text()
    if src.count(_STAGE_LINE) != 1:
        raise RuntimeError("the forward's stage line has moved; update the "
                           "planted faults")
    sources = {"as_is": (("fwd", "dh", "dw"), src)}
    for name, (kernels, edits) in KNOCKOUTS.items():
        sources[name] = (kernels, _knocked_out(src, name, kernels, edits))
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

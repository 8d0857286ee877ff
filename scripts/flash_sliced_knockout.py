#!/usr/bin/env python3
"""Time the flash kernels past head dim 256 with one design choice
undone at a time, in turns, on one NVIDIA card: the bf16 ones, or
(``--only tf32``) the f32 3xTF32 ones.

Builds ``bigdl_tpu_torch/csrc/flash_attention.cu`` as it is (with
``tf32.cuh``, which holds the 3xTF32 steps, inlined) and copies of it
with one exact text replacement each (``VARIANTS``: the forward's
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
its key tiles or kept K and V resident measured no faster, and went.
``--only tf32`` instead runs ``TF32_VARIANTS`` in f32 at ``TF32_SHAPES``
(B2 S2048 and B4 S4096 H2 D512, B2 S2048 H2 and H4 D1024): S's sums or
the output products' chained across steps (no fresh sums), S's steps
summed afresh every 4 or every K step (not every 2), S's high products
first, cvt.rna.tf32.f32 for the rounding (each of these in the forward,
dq and dk/dv, which share those steps); dP on each row group's grid; the
walked operands split inside the kernel (no split pass, no workspace);
the slice widths of the forward and dq (one choice for both) and of
dk/dv; and the forward's score product formed by one warpgroup alone
(not half of it by each). ``--only tf32_narrow`` runs
``TF32_NARROW_VARIANTS`` in f32 at ``TF32_NARROW_SHAPES`` (B4 S2048 with
H·D = 1024 at D 128, 64 and 32, the f32 training step's width and the
narrower ones): the forward at D 64 and 128 and dq at D <= 128 on the
sliced kernels with their hand-offs (64 rows a CTA; the forward's S
summed half by each warpgroup, P and α handed back; dq's P and dS),
not the 128-row ones (at D 32 the forward's variant runs the 128-row
kernel, as the sliced one cannot); and dk/dv at D <= 128 in 128-key
CTAs whose warpgroups each form Sᵀ and dPᵀ of their own keys and
accumulate both dv and dk (no Pᵀ hand-off). The variants that show
the error a choice keeps off are held to nothing. The f32 outputs are
held to the plain versions evaluated in float64
(``chip_smoke._flash_fwd_refs``,
``_flash_bwd_refs``). One line per shape, version and kernel with both
readings, their mean and the ratio of means to this checkout's kernel;
last, the card's name and power limit. ``--only fwd`` or ``--only bwd``
builds and times one side's bf16 variants alone. It exits 1 if a
replacement's text is not in the source (the line says which; an edit
of those lines must update it) or if any output of a variant held to
the limits is non-finite or past them, after every reading.

    python3 scripts/flash_sliced_knockout.py
        [--only fwd|bwd|tf32|tf32_narrow] [--seed N]
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

_HOPPER = (ROOT / "bigdl_tpu_torch/csrc/hopper.cuh").read_text()
_INT_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
_CVT_ROUND = ("  uint32_t y;\n"
              "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(y) "
              ": \"f\"(x));\n  return y;")
# split_in_kernel's splitter: a warpgroup's walked B box (raw f32 [64][32]
# in the 128-byte swizzle) into its tf32 parts, in place (hi) and at lo,
# 16 columns a thread, then a barrier of the warpgroup's own
_SPLIT_BOX = """__device__ __forceinline__ void tf_split_box(uint32_t b,
                                             uint32_t lo) {
  const int i = threadIdx.x % 128, r = i / 2;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t at = tf_at(r, 16 * (i % 2) + j);
    uint32_t h, w;
    split_tf32(ld_shared(b + at), h, w);
    st_shared(b + at, __uint_as_float(h));
    st_shared(lo + at, __uint_as_float(w));
  }
  fence_proxy_async();
  named_sync(5 + threadIdx.x / 128, 128);
}

"""
# dp_grid's functions: the group-grid split, tf_dp_step (dP's score step)
# and the split pass's grid kernel
_DP_GRID = """\
// The constant c with which (x + c) - c rounds x to nearest on the grid
// 2^(e - 10) of a group whose largest magnitude is amax < 2^e (amax's
// biased exponent E: e = E - 126; c = 1.5 · 2^23 · 2^(e - 10))
__device__ __forceinline__ float tf32_grid(float amax) {
  return __uint_as_float((((__float_as_uint(amax) >> 23) + 14u) << 23) |
                         0x400000u);
}
// x = hi + lo on a group's grid (tf32_grid's c): hi a multiple of 2^(e -
// 10) of at most 11 bits (a valid tf32), lo = tf32(x - hi) (x - hi is
// exact in f32). Two such hi parts multiply to a multiple of 2^(ea + eb
// - 20) below 2^(ea + eb): every product of two groups sits on one grid
// 20 bits below the largest a product of them can be.
__device__ __forceinline__ void split_tf32_grid(float x, float c,
                                                uint32_t& hi, uint32_t& lo) {
  const float h = __fsub_rn(__fadd_rn(x, c), c);
  hi = __float_as_uint(h);
  lo = to_tf32(x - h);
}

// One score step of the second score product (dP = dO·Vᵀ; dPᵀ = V·dOᵀ),
// whose sums dS = P∘(dP - delta) cancels, as tf_score_step but exact up
// to the f32 additions: A and B split on the grid of each row's group of
// 8 columns (split_tf32_grid; B's parts written so by the split pass),
// so the tensor cores add the hi·hi products of a K step of 8 without
// dropping a bit (they keep 20 bits below the largest term, the width
// of that grid) when nothing else is in the sum. Per K step: hi·lo,
// lo·hi and lo·lo in a fresh accumulator, added to s in f32; then hi·hi
// alone, added to s in f32.
__device__ __forceinline__ void tf_dp_step(float (&s)[32], uint32_t a_t,
                                           uint32_t b_t, uint32_t blo,
                                           bool first) {
  const int i = threadIdx.x % 128, l = i % 32;
  const int r0 = 16 * (i / 32) + l / 4, t = l % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = ld_shared(a_t + tf_at(r0 + 8 * (e & 1), 8 * kk + t +
                                                         4 * (e >> 1)));
    // rows r0 and r0 + 8: their 8 columns lie in the lane quad
    const float c[2] = {
        tf32_grid(quad_max(fmaxf(fabsf(x[0]), fabsf(x[2])))),
        tf32_grid(quad_max(fmaxf(fabsf(x[1]), fabsf(x[3]))))};
    uint32_t ah[1][4], al[1][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32_grid(x[e], c[e & 1], ah[0][e], al[0][e]);
    const uint32_t k = 32 * kk;
    float d[32];
    wg_fence();
    wgmma_tf32_rs_n64(d, ah[0], desc(blo + k), 0);
    wgmma_tf32_rs_n64(d, al[0], desc(b_t + k), 1);
    wgmma_tf32_rs_n64(d, al[0], desc(blo + k), 1);
    wg_commit();
    wg_wait();
    keep(d);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = first && kk == 0 ? d[e] : s[e] + d[e];
    wg_fence();
    wgmma_tf32_rs_n64(d, ah[0], desc(b_t + k), 0);
    wg_commit();
    wg_wait();
    keep(d);
    keep(ah);
    keep(al);
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] += d[e];
  }
}

__global__ void __launch_bounds__(256)
tf32_split_grid_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                       float4* __restrict__ lo, int64_t n4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4 / 2; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 u = x[2 * i], w = x[2 * i + 1];
    const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    const float c = tf32_grid(amax);
    uint32_t hh[8], r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) split_tf32_grid(v[j], c, hh[j], r[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      hi[2 * i + j] = make_float4(
          __uint_as_float(hh[4 * j]), __uint_as_float(hh[4 * j + 1]),
          __uint_as_float(hh[4 * j + 2]), __uint_as_float(hh[4 * j + 3]));
      lo[2 * i + j] = make_float4(
          __uint_as_float(r[4 * j]), __uint_as_float(r[4 * j + 1]),
          __uint_as_float(r[4 * j + 2]), __uint_as_float(r[4 * j + 3]));
    }
  }
}

"""
# dp_grid's call of tf_dp_step for warpgroup 1, in the kernel whose text
# goes on with `then`
_DP_CALL = (
    """        tf_score_step(s, st + 2 * G * kTfBox, st + (2 * G + 1) * kTfBox,
                      st + (4 + G) * kTfBox, c == 0);
{then}""",
    """        if constexpr (G == 0)
          tf_score_step(s, st, st + kTfBox, st + 4 * kTfBox, c == 0);
        else
          tf_dp_step(s, st + 2 * kTfBox, st + 3 * kTfBox, st + 5 * kTfBox,
                     c == 0);
{then}""")


def _dp_call(then):
    """dp_grid's replacement at the score step of the kernel whose text
    goes on with ``then``."""
    return tuple(x.format(then=then) for x in _DP_CALL)


#: the f32 kernels past D 256 (``--only tf32``), as ``VARIANTS``; the
#: fourth field, True, marks a variant held to no limit (its error is the
#: reading)
TF32_VARIANTS = {
    "chained_score": (
        ("fwd", "dq", "dkdv"),
        "the score products summed in one tensor-core chain over all of D "
        "(no fresh sum every 2 K steps)",
        [("    float acc[32];\n    wg_fence();",
          "    float (&acc)[32] = s;\n    wg_fence();"),
         ("      wgmma_tf32_rs_n64(acc, ah[kk], desc(blo + k), kk > 0);",
          "      wgmma_tf32_rs_n64(acc, ah[kk], desc(blo + k), "
          "!first || k0 > 0 || kk > 0);"),
         ("#pragma unroll\n    for (int e = 0; e < 32; ++e)\n"
          "      s[e] = first && k0 == 0 ? acc[e] : s[e] + acc[e];", "")],
        True),
    "chained_out": (
        ("fwd", "dq", "dkdv"),
        "the output products summed in one tensor-core chain over the "
        "walked tiles (no fresh sum every 4 K steps)",
        [("  for (int half = 0; half < 2; ++half) {\n    float d[32];",
          "  for (int half = 0; half < 2; ++half) {\n"
          "    float (&d)[32] = acc;"),
         ("      wgmma_tf32_rs_n64(d, ah[kk], desc(blo + k), kk > 0);",
          "      wgmma_tf32_rs_n64(d, ah[kk], desc(blo + k), 1);"),
         ("#pragma unroll\n    for (int e = 0; e < 32; ++e) acc[e] += d[e];"
          "\n  }\n}", "  }\n}")], True),
    "score_ks4": (
        ("fwd", "dq", "dkdv"),
        "each score step's 4 K steps in one fresh sum (not 2 + 2)",
        [("constexpr int kTfScoreKs = 2;", "constexpr int kTfScoreKs = 4;")],
        True),
    "score_ks1": (
        ("fwd", "dq", "dkdv"),
        "a fresh sum for every K step of a score step (4, not 2 + 2)",
        [("constexpr int kTfScoreKs = 2;", "constexpr int kTfScoreKs = 1;")]),
    "hi_first": (
        ("fwd", "dq", "dkdv"),
        "each fresh score sum's hi·hi products before its low terms",
        [("""#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk) {
      const uint32_t k = 32 * (k0 + kk);
      wgmma_tf32_rs_n64(acc, ah[kk], desc(blo + k), kk > 0);
      wgmma_tf32_rs_n64(acc, al[kk], desc(b_t + k), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk)
      wgmma_tf32_rs_n64(acc, ah[kk], desc(b_t + 32 * (k0 + kk)), 1);""",
          """#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk)
      wgmma_tf32_rs_n64(acc, ah[kk], desc(b_t + 32 * (k0 + kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk) {
      const uint32_t k = 32 * (k0 + kk);
      wgmma_tf32_rs_n64(acc, ah[kk], desc(blo + k), 1);
      wgmma_tf32_rs_n64(acc, al[kk], desc(b_t + k), 1);
    }""")], True),
    "cvt_round": (
        ("fwd", "dq", "dkdv"),
        "the tf32 rounding by cvt.rna.tf32.f32 (the header inlined with it)",
        [('#include "hopper.cuh"',
          _HOPPER.replace(_INT_ROUND, _CVT_ROUND)
          .replace("#pragma once", ""))]),
    "dp_grid": (
        ("dq", "dkdv"),
        "dP (dPᵀ) exact in each tensor-core K step: its operands split on "
        "the grid of each row's group of 8 columns (hi·hi products on one "
        "grid), per K step the low products and hi·hi in fresh sums of "
        "their own, each added in f32 (four TF32 products, two waits)",
        [("// s (a 64 x 64 accumulator: rows this CTA's, columns the walked "
          "tile's) as\n",
          _DP_GRID + "// s (a 64 x 64 accumulator: rows this CTA's, "
          "columns the walked tile's) as\n"),
         _dp_call("""        ring.release();
      }
      if constexpr (G == 0) {"""),
         _dp_call("""        ring.release();
      }
      warp_wait(sfull, sph);"""),
         ("""  for (int j = 0; j < tensors; ++j)
    if (int e = tf_split_pass(j ? x1 : x0, work + 2 * j * n,
                              work + (2 * j + 1) * n, n, sms, st))
      return e;""",
          """  for (int j = 0; j < tensors; ++j) {
    const int64_t want = (n / 4 + 255) / 256;
    const int blocks = static_cast<int>(want < 8 * sms ? want : 8 * sms);
    (j ? tf32_split_grid_kernel : tf32_split_kernel)<<<blocks, 256, 0, st>>>(
        static_cast<const float4*>(j ? x1 : x0),
        reinterpret_cast<float4*>(work + 2 * j * n),
        reinterpret_cast<float4*>(work + (2 * j + 1) * n), n / 4);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }""")]),
    "split_in_kernel": (
        ("dq", "dkdv"),
        "no split pass and no workspace: TMA brings the walked B boxes "
        "raw, and each consumer warpgroup splits its box in shared "
        "memory before its score step",
        [("// One score step: s (+)= A·Bᵀ over 32 columns",
          _SPLIT_BOX + "// One score step: s (+)= A·Bᵀ over 32 columns"),
         ("  const int r0 = 16 * (i / 32) + l / 4, t = l % 4;\n"
          "#pragma unroll\n"
          "  for (int k0 = 0; k0 < 4; k0 += kTfScoreKs) {",
          "  const int r0 = 16 * (i / 32) + l / 4, t = l % 4;\n"
          "  tf_split_box(b_t, blo);\n#pragma unroll\n"
          "  for (int k0 = 0; k0 < 4; k0 += kTfScoreKs) {"),
         ("  tma_load(dst + 4 * kTfBox, b0l, bar, 32 * c, h, w0, b);\n"
          "  tma_load(dst + 5 * kTfBox, b1l, bar, 32 * c, h, w0, b);\n",
          ""),
         ("ring.acquire(t, kTfStage), ring.full(), c, h, q0,",
          "ring.acquire(t, 4 * kTfBox), ring.full(), c, h, q0,"),
         ("ring.acquire(t, kTfStage), ring.full(), c, h, k0,",
          "ring.acquire(t, 4 * kTfBox), ring.full(), c, h, k0,"),
         ("  if (int e = tf_split(p, k, v, work, B, Skv, H, D, st)) "
          "return e;",
          "  if (int e = make_map(&p[0], k, B, Skv, H, D, 64, true)) "
          "return e;\n"
          "  if (int e = make_map(&p[2], v, B, Skv, H, D, 64, true)) "
          "return e;\n  p[1] = p[0];\n  p[3] = p[2];"),
         ("  if (int e = tf_split(p, q, dout, work, B, Sq, H, D, st)) "
          "return e;",
          "  if (int e = make_map(&p[0], q, B, Sq, H, D, 64, true)) "
          "return e;\n"
          "  if (int e = make_map(&p[2], dout, B, Sq, H, D, 64, true)) "
          "return e;\n  p[1] = p[0];\n  p[3] = p[2];")]),
    "dq_slices8": (
        ("fwd", "dq"),
        "the forward and dq: slices of up to 8 chunks whatever the grid "
        "(one at D 512)",
        [("  if (rows * fewest <= sms) {", "  if (false) {")]),
    "dq_slices6": (
        ("fwd", "dq"),
        "the forward and dq: slices of up to 6 chunks whatever the grid "
        "(two at D 512)",
        [("  if (rows * fewest <= sms) {", "  if (true) {")]),
    "dkdv_own3": (
        ("dkdv",),
        "dk/dv: slices of 3 chunks (3 + 3 + 2 at D 512)",
        [("  switch (sl_own(chunks(D))) {\n    case 1:\n"
          "      return dkdv_sliced_tf32_own<1>(",
          "  switch (3) {\n    case 1:\n"
          "      return dkdv_sliced_tf32_own<1>(")]),
    "fwd_whole_s": (
        ("fwd",),
        "the forward: warpgroup 0 forms all of S (D / 32 score steps a "
        "key tile, three boxes a stage), warpgroup 1 no part of it",
        [("  const int nh = D / 64;                   // score steps a key "
          "tile",
          "  const int nh = D / 32;                   // score steps a key "
          "tile"),
         ("          const uint32_t dst = ring.acquire(t, kTfStage);\n"
          "          for (int g = 0; g < 2; ++g) {",
          "          const uint32_t dst = ring.acquire(t, 3 * kTfBox);\n"
          "          for (int g = 0; g < 1; ++g) {"),
         ("        tf_score_step(s, st + 2 * G * kTfBox, st + (2 * G + 1) * "
          "kTfBox,\n                      st + (4 + G) * kTfBox, j == 0);",
          "        if (G == 0)\n"
          "          tf_score_step(s, st, st + kTfBox, st + 4 * kTfBox, "
          "j == 0);"),
         ("tf_give(xs, s);", ";"),
         ("tf_take(s, xs);", ";")]),
}
TF32_SHAPES = ((2, 2048, 2, 512), (4, 4096, 2, 512), (2, 2048, 2, 1024),
               (2, 2048, 4, 1024))

# dkdv_rows's kernel and launcher: a CTA of 128 keys, each consumer
# warpgroup forming Sᵀ and dPᵀ of its own 64, Pᵀ's and dSᵀ's parts in
# tiles of its own, and both dv and dk of its keys; a stage holds both
# warpgroups' A boxes (K, or V) and the walked tile's B parts (Q's, or
# dO's), an output step the tile's dO and Q columns of a chunk
_DKDV_ROWS = """\
template <int NC>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_dkdv_rows_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap dom,
                            const __grid_constant__ CUtensorMap qhm,
                            const __grid_constant__ CUtensorMap qlm,
                            const __grid_constant__ CUtensorMap dohm,
                            const __grid_constant__ CUtensorMap dolm,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int Sq, int Skv, int D, int ns,
                            float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 32, halves = D % 64 ? 1 : 2;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kRowsStage;   // Pᵀ, dSᵀ parts, a set each
  const uint32_t stats = xb + 16 * kTfBox;     // lse, then delta: f32 [64]
  TfRing ring{base, stats + kStatBytes, ns};
  const uint32_t sfull = ring.bars + 16 * kTfMaxStages, sempty = sfull + 8;
  auto at = [&] { return base + ring.st * kRowsStage; };
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int k0 = 128 * blockIdx.y;          // the lowest, heaviest, first
  const int nq = (Sq + 63) / 64;
  const int qt0 = causal ? min(k0 / 64, nq) : 0;
  tf_init(ring.bars, ns);

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kSlConsumers) {
      int t = 0;
      for (int qt = qt0; qt < nq; ++qt) {
        const int q0 = 64 * qt;
        for (int j = 0; j < 2 * nc; ++j, ++t, ring.next()) {
          const bool dp = j >= nc;
          const int c = 32 * (j % nc);
          ring.acquire(t, kRowsStage);
          const uint32_t dst = at();
          tma_load(dst, dp ? &vm : &km, ring.full(), c, h, k0, b);
          tma_load(dst + kTfBox, dp ? &vm : &km, ring.full(), c, h, k0 + 64,
                   b);
          tma_load(dst + 2 * kTfBox, dp ? &dohm : &qhm, ring.full(), c, h,
                   q0, b);
          tma_load(dst + 3 * kTfBox, dp ? &dolm : &qlm, ring.full(), c, h,
                   q0, b);
        }
        for (int p = 0; p < NC; ++p, ++t, ring.next()) {
          ring.acquire(t, 2 * halves * kTfBox);
          for (int e = 0; e < halves; ++e) {
            tma_load(at() + e * kTfBox, &dom, ring.full(), 64 * p + 32 * e,
                     h, q0, b);
            tma_load(at() + (2 + e) * kTfBox, &qm, ring.full(),
                     64 * p + 32 * e, h, q0, b);
          }
        }
      }
    } else if (tid / 32 == kSlConsumers / 32 + 1) {
      const int ln = tid % 32;
      const float* const lse_bh = lse + static_cast<int64_t>(b) * Sq * H + h;
      const float* const delta_bh =
          delta + static_cast<int64_t>(b) * Sq * H + h;
      for (int qt = qt0; qt < nq; ++qt) {
        if (qt > qt0) bar_wait(sempty, (qt - qt0 - 1) & 1);
        for (int i = 64 * qt + ln; i < 64 * qt + 64; i += 32) {
          const uint32_t a = stats + 4 * (i - 64 * qt);
          st_shared(a, i < Sq ? lse_bh[static_cast<int64_t>(i) * H] : 0.f);
          st_shared(a + 4 * 64,
                    i < Sq ? delta_bh[static_cast<int64_t>(i) * H] : 0.f);
        }
        __threadfence_block();
        __syncwarp();
        if (ln == 0) bar_arrive(sfull);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  const int l = tid % 32;
  const int krow = 16 * ((tid / 32) % 4) + l / 4;     // of the 64 keys
  auto consume = [&](auto role) {
    constexpr int G = decltype(role)::kDk ? 1 : 0;
    const int kg = k0 + 64 * G;            // this warpgroup's keys
    const uint32_t pp = xb + 8 * G * kTfBox, dsp = pp + 4 * kTfBox;
    // query tiles wholly before its keys (causal) pass without products
    const int first = causal ? kg / 64 : 0;
    float adv[NC][32], adk[NC][32], s[32];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      zero(adv[j]);
      zero(adk[j]);
    }
    zero(s);
    int sph = 0;
    for (int qt = qt0; qt < nq; ++qt) {
      const bool live = qt >= first;
      const int q0 = 64 * qt;
      for (int c = 0; c < nc; ++c) {       // Sᵀ = K·Qᵀ
        ring.wait();
        const uint32_t st = at();
        if (live)
          tf_score_step(s, st + G * kTfBox, st + 2 * kTfBox, st + 3 * kTfBox,
                        c == 0);
        ring.release();
      }
      warp_wait(sfull, sph);               // the tile's lse and delta
      sph ^= 1;
      if (live) {
        const bool edge = (causal && kg + 63 > q0) || q0 + 64 > Sq;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = q0 + acc_col(i, l), kpos = kg + krow + acc_row(i);
          float x = s[i] * scale;
          if (edge)
            x = qpos >= Sq ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
          s[i] = expf(x - ld_shared(stats + 4 * acc_col(i, l)));
        }
        tf_put(pp, pp + 2 * kTfBox, s);
      }
      for (int c = 0; c < nc; ++c) {       // dPᵀ = V·dOᵀ
        ring.wait();
        const uint32_t st = at();
        if (live)
          tf_score_step(s, st + G * kTfBox, st + 2 * kTfBox, st + 3 * kTfBox,
                        c == 0);
        ring.release();
      }
      if (live) {
        float p[32];
        tf_get(p, pp, pp + 2 * kTfBox);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = p[i] *
                 (s[i] - ld_shared(stats + 4 * (64 + acc_col(i, l)))) *
                 scale;
        tf_put(dsp, dsp + 2 * kTfBox, s);
        fence_proxy_async();
        named_sync(1 + G, 128);
      }
      __syncwarp();
      if (l == 0) bar_arrive(sempty);      // lse and delta read
#pragma unroll
      for (int j = 0; j < NC; ++j) {       // dvᵀ += dOᵀ·P, dkᵀ += Qᵀ·dS
        ring.wait();
        if (live) {
          tf_out_step(adv[j], at(), pp, pp + 2 * kTfBox, 32 * halves);
          tf_out_step(adk[j], at() + 2 * kTfBox, dsp, dsp + 2 * kTfBox,
                      32 * halves);
        }
        ring.release();
      }
    }
    tf_store<NC>(dv, adv, NC, b, h, kg, 0, Skv, H, D);
    tf_store<NC>(dk, adk, NC, b, h, kg, 0, Skv, H, D);
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

template <int NC>
int dkdv_rows_tf32(int D, const CUtensorMap (&m)[4],
                   const CUtensorMap (&p)[4], const float* lse,
                   const float* delta, void* dk, void* dv, int B, int H,
                   int Sq, int Skv, float scale, int causal,
                   cudaStream_t st) {
  const int ns = min(kTfMaxStages,
                     static_cast<int>((kSmemMax - 1024 - 16 * kTfBox -
                                       kStatBytes -
                                       8 * (2 * kTfMaxStages + 2)) /
                                      kRowsStage));
  const size_t smem = 1024 + ns * kRowsStage + 16 * kTfBox + kStatBytes +
                      8 * (2 * kTfMaxStages + 2);
  auto kernel = flash_dkdv_rows_tf32_kernel<NC>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Skv + 127) / 128);
  kernel<<<grid, kSlThreads, smem, st>>>(
      m[0], m[1], m[2], m[3], p[0], p[1], p[2], p[3], lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Skv, D, ns,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

"""

#: the f32 forward, dq and dk/dv at head dims up to 128 (``--only
#: tf32_narrow``), as ``TF32_VARIANTS``: the 128-row forward and dq undone
#: (the S half and P/α hand-off, or the P/dS hand-off, back), and dk/dv
#: in 128-key CTAs without its Pᵀ hand-off
TF32_NARROW_VARIANTS = {
    "fwd_handoff": (
        ("fwd",),
        "the forward at D 64 and 128 on the sliced kernel of D 192 and "
        "256 (64 query rows a CTA, each warpgroup summing half of S over "
        "D, warpgroup 1 handing its half to warpgroup 0, which runs the "
        "softmax and hands P's parts and α back; warpgroup 0 one chunk "
        "of oᵀ, warpgroup 1 the rest), not the 128-row kernel; at D 32, "
        "where the sliced kernel's halves of S would be 16 columns, the "
        "128-row kernel still",
        [("  if (D <= 64)\n    return fwd_rows_tf32<1>(D, m, kp, o, lse, B, "
          "H, Sq, Skv, scale, causal,\n                            st);\n"
          "  if (D <= 128)\n    return fwd_rows_tf32<2>(D, m, kp, o, lse, "
          "B, H, Sq, Skv, scale, causal,\n                            "
          "st);\n",
          "  if (D <= 32)\n    return fwd_rows_tf32<1>(D, m, kp, o, lse, B, "
          "H, Sq, Skv, scale, causal,\n                            st);\n"),
         ("  switch ((own + 1) / 2) {\n    case 2:\n      return "
          "fwd_sliced_tf32_own<2>(",
          "  switch ((own + 1) / 2) {\n    case 1:\n      return "
          "fwd_sliced_tf32_own<1>(D, own, m, kp, o, lse, B, H, Sq, Skv, "
          "scale, causal, st);\n    case 2:\n      return "
          "fwd_sliced_tf32_own<2>(")]),
    "dq_handoff": (
        ("dq",),
        "dq at D <= 128 on the sliced kernel of D 192 and 256 (64 query "
        "rows a CTA, warpgroup 0 forming S and P, warpgroup 1 dP and dS, "
        "P and dS handed between them through shared memory; the walked K "
        "and V parts loaded once a 64 rows), not the 128-row kernel",
        [("  if (D <= 64)\n    return dq_rows_tf32<1>(D, m, p, lse, delta, "
          "dq_out, B, H, Sq, Skv, scale,\n                           causal, "
          "st);\n  if (D <= 128)\n    return dq_rows_tf32<2>(D, m, p, lse, "
          "delta, dq_out, B, H, Sq, Skv, scale,\n                           "
          "causal, st);\n", ""),
         ("  switch ((own + 1) / 2) {\n    case 2:\n      return "
          "dq_sliced_tf32_own<2>(",
          "  switch ((own + 1) / 2) {\n    case 1:\n      return "
          "dq_sliced_tf32_own<1>(D, own, m, p, lse, delta, dq_out, B, H, "
          "Sq, Skv, scale, causal, st);\n    case 2:\n      return "
          "dq_sliced_tf32_own<2>(")]),
    "dkdv_rows": (
        ("dkdv",),
        "dk/dv at D <= 128: CTAs of 128 keys, each warpgroup forming Sᵀ "
        "and dPᵀ of its own 64 and accumulating both dv and dk of them "
        "(no Pᵀ hand-off; the walked Q and dO parts loaded once a 128 "
        "keys)",
        [("// dk and dv: CTA = 64 keys of one (b, h), the heaviest (lowest) "
          "tiles\n",
          _DKDV_ROWS + "// dk and dv: CTA = 64 keys of one (b, h), the "
          "heaviest (lowest) tiles\n"),
         ("  if (int e = tf_split(p, q, dout, work, B, Sq, H, D, st)) "
          "return e;\n",
          "  if (int e = tf_split(p, q, dout, work, B, Sq, H, D, st)) "
          "return e;\n"
          "  if (D <= 64)\n    return dkdv_rows_tf32<1>(D, m, p, lse, "
          "delta, dk, dv, B, H, Sq, Skv, scale, causal, st);\n"
          "  if (D <= 128)\n    return dkdv_rows_tf32<2>(D, m, p, lse, "
          "delta, dk, dv, B, H, Sq, Skv, scale, causal, st);\n")]),
}
TF32_NARROW_SHAPES = ((4, 2048, 8, 128), (4, 2048, 16, 64),
                      (4, 2048, 32, 32))


def _variant_sources(text: str, variants: dict) -> tuple[dict, list]:
    """This checkout's source and each variant's; the replacements whose
    text is not found."""
    out, missing = {"this": text}, []
    for name, (_, _, edits, *_) in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                missing.append(f"{name}: {old.strip()!r}")
            src = src.replace(old, new)
        out[name] = src
    return out, missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("fwd", "bwd", "tf32", "tf32_narrow"),
                    help="the bf16 forward's variants, the bf16 "
                    "backward's, the f32 3xTF32 kernels' past D 256, or "
                    "the f32 3xTF32 forward's, dq's and dk/dv's up to D 128")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_sliced_knockout: CUDA is not available",
              file=sys.stderr)
        return 2
    tf32 = args.only in ("tf32", "tf32_narrow")
    chosen_variants = (TF32_NARROW_VARIANTS if args.only == "tf32_narrow"
                       else TF32_VARIANTS) if tf32 else {
        name: v for name, v in VARIANTS.items()
        if args.only is None or (v[0] == ("fwd",)) == (args.only == "fwd")}
    # the 3xTF32 steps live in tf32.cuh: every version builds with it
    # inlined, so that a variant may edit them
    sources, past = _variant_sources(_build.inline_header(
        (ROOT / "bigdl_tpu_torch/csrc/flash_attention.cu").read_text(),
        "tf32.cuh"), chosen_variants)
    sources = {k: v for k, v in sources.items()
               if k == "this" or k in chosen_variants}
    if past:
        print("[knockout] replacement text not found: " + "; ".join(past),
              flush=True)
    kernels = {name: v[0] for name, v in chosen_variants.items()}
    kernels["this"] = tuple(k for k in ("fwd", "dq", "dkdv")
                            if any(k in ks for ks in kernels.values()))
    for name, (_, what, *_) in chosen_variants.items():
        print(f"[knockout] {name}: {what}", flush=True)
    unheld = {name for name, v in chosen_variants.items() if v[3:]}
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
            for shape in (TF32_NARROW_SHAPES if args.only == "tf32_narrow"
                          else TF32_SHAPES if tf32 else SHAPES):
                past += _shape(fns, kernels, gen, *shape, card,
                               torch.float32 if tf32 else torch.bfloat16,
                               unheld)
        finally:
            fa._kernel_fns = chosen
    if past:
        print("[knockout] failed: " + "; ".join(past), flush=True)
    print(card)
    return 1 if past else 0


def _shape(fns, kernels, gen, b, s, h, d, card, dtype, unheld):
    """Every version at one shape in ``dtype``: the kernels it changes
    checked, then timed in turns; returns the outputs that are
    non-finite or past their limit (of the versions not in
    ``unheld``)."""
    scale = d ** -0.5
    name = str(dtype)[6:]
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen)
                   .to(dtype).to(chip_smoke._DEV)
                   for _ in range(4))
    ro, rlse = chip_smoke._flash_fwd_refs(fa, q, k, v, scale, True)
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
    if wanted & {"dq", "dkdv"}:
        dq, dk, dv = chip_smoke._flash_bwd_refs(fa, q, k, v, do, rlse,
                                                delta, scale, True)
        refs["dq"] = (("dq", dq),)
        refs["dkdv"] = (("dk", dk), ("dv", dv))
    past = []
    for version, fn in fns.items():
        fa._kernel_fns = lambda f=fn: f
        for kernel in kernels[version]:
            got = calls[kernel]()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            worst = {what: chip_smoke._flash_err(what, g, ref)[1]
                     for (what, ref), g in zip(refs[kernel], got)}
            if version not in unheld and not (
                    all(w <= 1 for w in worst.values())
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
        print(f"[knockout] flash_{kernel}[{name}] {version} B={b} S={s} "
              f"H={h} D={d} causal card='{card}' " + json.dumps(dict(
                  ms=t, mean_ms=float(np.mean(t)),
                  ratio=float(np.mean(t)) / base)), flush=True)
    return past


if __name__ == "__main__":
    sys.exit(main())

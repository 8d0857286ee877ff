// Flash attention for Hopper (sm_90a): forward with lse, and the
// FlashAttention-2 backward as two kernels (dq; dk and dv fused).
//
// Replaces the Pallas TPU kernels of bigdl_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_*kernel  <- `_fwd_kernel`   (the pl.pallas_call at line 190)
//   flash_dq_*kernel   <- `_dq_kernel`    (the pl.pallas_call at line 306)
//   flash_dkdv_*kernel <- `_dkdv_kernel`  (the pl.pallas_call at line 322)
// They compute the same functions, not the same programs:
//
//   s    = q·kᵀ·scale, or the finite -1e9 where causal and kpos > qpos
//   o    = softmax(s)·v,  lse = logsumexp(s)            (forward)
//   p    = exp(s - lse),  dS = p∘(dO·vᵀ - delta)·scale  (backward)
//   dq   = dS·k,  dk = dSᵀ·q,  dv = pᵀ·dO
//
// with delta = rowsum(dO∘o) - g_lse computed by the caller. Rounding as
// the TPU kernel: p is rounded to v's dtype before p·v (unnormalised, at
// the running max of the online softmax) and to dO's dtype before pᵀ·dO;
// dS (from the unrounded p) to k's dtype for dq and to q's dtype for dk
// (all inputs share one dtype T here). Sums are f32; o/dq/dk/dv are
// written in T, lse in f32.
//
// Layout: tensors are (B, S, H, D) as the model produces them; element
// [b, s, h, d] sits at ((b*S + s)*H + h)*D + d, so a tile of rows of one
// head is rows at a stride of H·D elements. lse and delta are (B, S, H).
//
// Bound on the H100: at the training shapes (B 4, S 2048, H 8, D 128,
// causal) the forward does 34.4 GFLOP on 67 MB of inputs and outputs in
// bf16, about 510 flops a byte, and the backward kernels more: above the
// ~295 flops/byte at which the tensor cores bind, so all three are bound
// by operations. Two kernel families, chosen by dtype in the C entries
// (a dispatch on the dtype, not a fallback; nothing reroutes a call):
//
// bfloat16 -> tensor cores (namespace tc, flash_*_tc_kernel):
// - Products are `wgmma` (m64nNk16, f32 sums): a warpgroup multiplies a
//   64-row tile. Q·Kᵀ-type products take both operands from shared
//   memory, K-major; products with D as output (P·V, dS·K, Pᵀ·dO,
//   dSᵀ·Q) take P or dS from registers, rounded to bf16 in the
//   accumulator's own layout (the f32 accumulator of a m64nN product is
//   the A fragment of the next, two columns per register), and V, K, dO
//   or Q from shared memory in their MN-major (transposed) form, which
//   16-bit types allow. No product needs a transposed copy.
// - Tiles come in by TMA: each tensor is a 4-D map (D, H, S, B) with a
//   box of (64, 1, rows, 1), so a tile is ceil(D/64) boxes of [rows][64]
//   bf16 (128-byte rows, 128-byte swizzle, the wgmma descriptors'
//   layout), and rows past S are zero-filled inside their own (b, h) —
//   never the next batch's rows. At D 32 the box reaches past D and its
//   columns 32..63 fill with zeros: products over D take 2 K steps,
//   products with D as output run at N 64 and drop the zero half. The maps are made in the C entry from the
//   pointers and shapes (cuTensorMapEncodeTiled, found through
//   cudaGetDriverEntryPoint so the library links no -lcuda) and passed
//   as __grid_constant__ parameters.
// - One CTA = two consumer warpgroups (256 threads), each owning 64 rows
//   of the CTA's 128 (query rows for fwd and dq, key rows for dkdv).
//   The walked operand tiles (K and V; Q and dO for dkdv) sit in a ring
//   of 2 stages with full/empty mbarriers; thread 0 refills a stage as
//   soon as all 8 warps have released it. No producer warp and no
//   setmaxnreg: with 256 threads every thread may hold 255 registers,
//   which dk and dv (64 + 64 f32 each at D 128) plus the two score
//   tiles need.
// - Forward: 128 queries x 128-key tiles; online softmax in f32
//   registers (row max and sum over the four lanes of a row quad).
//   dq: 128 queries x 64-key tiles, S and dP recomputed per tile.
//   dkdv: 128 keys x 64-query tiles, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so
//   Pᵀ and dSᵀ come out with keys as rows, the A operand of dv += Pᵀ·dO
//   and dk += dSᵀ·Q. The two backward launches cost 7 half-products
//   against a fused backward's 5, but keep dq deterministic, with no
//   atomics and no f32 scratch.
// - Causal: tiles wholly above the diagonal are never loaded; scores are
//   masked element-wise only in tiles that cross the diagonal or the end
//   of the sequence. Outputs are stored from registers, rows past S
//   skipped.
// - Head dims 192 and 256 (chunks(D) = 3, 4): the tiles above hold whole
//   tiles of D columns in shared memory (227 KB a block) and D-wide
//   accumulators in registers (255 a thread), and at D 256 they would
//   need: forward 64 KB of Q + 2 stages x 128 KB of K/V = 320 KB, with o
//   (128 registers) + s (64) + P over 255; dq 128 KB of Q/dO + 2 x 64 KB
//   = 256 KB; dkdv 256 KB, with dk + dv at 256 registers. So past D 128:
//   - forward: 128 queries x 64-key tiles: 64 + 2 x 64 = 192 KB at D 256
//     (144 KB at 192); o 128 + s 32 + P 16 registers;
//   - dq: one warpgroup of 64 query rows a CTA (128 threads): Q 32 + dO
//     32 + 2 x 64 KB of K/V = 192 KB; dq 128 + s 32 + dP 32 registers;
//   - dkdv (flash_dkdv_split_tc_kernel): 64 keys a CTA, K 32 + V 32 + 2 x
//     64 KB of Q/dO = 192 KB. Both warpgroups form the same Sᵀ = K·Qᵀ
//     over the CTA's 64 keys; warpgroup 0 then accumulates dv += Pᵀ·dO,
//     warpgroup 1 forms dPᵀ = V·dOᵀ and accumulates dk += dSᵀ·Q. Each
//     holds one D-wide accumulator (128 registers at D 256) beside s, dP
//     and a fragment tile; splitting D between the warpgroups instead
//     would need both Sᵀ and dPᵀ in each (the same 3 products on the
//     longer path) and 96-column halves at D 192.
//   They are correct first; their speed is later work (PERF.md).
//
// float32 -> every kernel at every head dim on the tensor cores in
// 3xTF32 (one TF32 product would round the inputs past the f32 limits):
// - dk/dv up to D 256, and dq and the forward at D 192 and 256, run the
//   3xTF32 kernels of the widths past 256
//   (tc::flash_dkdv_sliced_tf32_kernel<OWN>,
//   tc::flash_dq_sliced_tf32_kernel<OWN>,
//   tc::flash_fwd_sliced_tf32_kernel<OWN>, below) with one slice of all
//   of D: chunks(D) 64-column chunks, 1, 1, 2, 3, 4 at D 32, 64, 128,
//   192, 256. In dk/dv each warpgroup holds all of them (OWN =
//   chunks(D)); dq's and the forward's warpgroup 0 takes ceil(chunks /
//   2) (OWN 2) and warpgroup 1 the rest. A walked tile costs D/32 score
//   steps and OWN output steps; dq does 3 half-products, dk/dv 4 and the
//   forward 2, each three TF32 products, the least the function needs.
//   At D 32 a chunk is half a chunk: output steps load one [64][32] raw
//   box of each operand, A's rows past D are zeros (tf_out_step's
//   `cols`) and tf_store stops at D.
// - dq and the forward up to D 128 (tc::flash_dq_rows_tf32_kernel<NC>,
//   tc::flash_fwd_rows_tf32_kernel<NC>, NC = chunks(D)): CTAs of 128
//   query rows whose two warpgroups each form S (and dq's dP) of their
//   own 64 rows over all of D, with no hand-off between them; K's (and
//   V's) parts come once a 128 rows. The forward's warpgroup runs the
//   online softmax on its own S and puts P's parts and α in a tile of
//   its own. In the sliced kernels (64 rows a CTA; dq's warpgroup 0
//   forming S and P, warpgroup 1 dP and dS, P and dS handed through
//   shared memory; the forward's warpgroups each summing half of S,
//   warpgroup 1 handing its half to warpgroup 0, which hands P and α
//   back) dq took 1.100x, 1.384x and 1.454x the time at D 128, 64 and
//   32, and the forward 1.130x and 1.313x at D 128 and 64 (B4 S2048, H·D
//   = 1024, causal; scripts/flash_sliced_knockout.py --only tf32_narrow,
//   dq_handoff and fwd_handoff, NVIDIA H100 80GB HBM3, 700 W; the sliced
//   forward cannot run D 32, where its warpgroups' halves of S would be
//   16 columns). The same layout for dk/dv (128-key CTAs, each
//   warpgroup forming Sᵀ and dPᵀ of its own keys and accumulating both
//   dv and dk: 128 registers of accumulator beside the score tiles, and
//   a ring of 3 stages beside 128 KB of Pᵀ and dSᵀ parts) took 2.55x,
//   1.27x and 1.10x the kept kernel's time (knockout dkdv_rows), so
//   dk/dv keeps its hand-off. (The sliced dq, which dq_handoff runs at D
//   64 and 32, has fewer score steps a key tile there than its ring has
//   stages, so its warpgroup 0 waits on named barrier 3 for warpgroup
//   1's output steps to have read dS before it puts the next P in its
//   place.)
// - At the f32 training step's shape (B4 S2048 H8 D128, causal) the
//   forward and dq are 512 CTAs and dk/dv 1024, past one wave of the
//   SMs: the heaviest first, not paired. The forward takes 0.5776 ms, dq
//   0.8538 and dk/dv 1.1203, 36 %, 37 % and 37 % of their 3xTF32 bounds
//   (chip_smoke.py's [kernels]), 0.501x, 0.521x and 0.469x the CUDA-core
//   kernels they replaced (FMA tiles over staged rows) in turns
//   (scripts/flash_ab.py; NVIDIA H100 80GB HBM3, 700 W). The forward at
//   D 256 (one slice of the sliced kernel) takes 0.5540 ms, 0.298x the
//   CUDA-core one.
//
// past D 256, the bf16 forward -> tensor cores, D sliced
// (tc::flash_fwd_sliced_tc_kernel<OWN>; D any multiple of 64, a runtime
// value; no D limit). At D 512 the D 256 forward's tiles would need 128
// KB of Q + 2 x 128 KB of K/V and an f32 o of 256 registers a thread:
// a 64-row warpgroup holds an accumulator of at most 256 columns (128
// registers) beside s (32) and P (16), the D 256 forward's budget. So:
// - A CTA owns one slice of OWN 64-column output chunks, OWN <= 4 (256
//   columns: 128 registers of o): the fewest slices, as even as they
//   come (sl_own: D 320 3 + 2 chunks, 384 3 + 3, 448 4 + 3, 512 4 + 4,
//   576 3 x 3, 1024 4 x 4), the last slice's chunks past D computed on
//   TMA's zeros and not stored; slices of 4 alone (4 + 2 at D 384, 4 +
//   4 + 1 at 576) cost 1.027x and 1.042x (knockout own4). Its two
//   consumer warpgroups hold 64-row query tiles: 128 consecutive rows,
//   the heaviest CTAs first; or, causal where the grid fits one wave of
//   the card's SMs, tiles i and n - 1 - i of the n, so every CTA does
//   the same work (the heaviest
//   128-row CTA does twice the mean, and one wave has no later CTA to
//   even it out). Past one wave the scheduler balances whole CTAs, and a
//   paired CTA's lone heavy warpgroup is slower. scripts/
//   flash_sliced_knockout.py (one NVIDIA H100 80GB HBM3, 700 W, 132
//   SMs; causal, H2, ms paired / unpaired): 128 CTAs (B2 S2048 D512)
//   0.1367 / 0.1616, (D 384) 0.1103 / 0.1288; 192 CTAs (D 576) 0.2130 /
//   0.1698; 256 (B2 S4096 D512) 0.4155 / 0.3182; 384 (B3) 0.6249 /
//   0.5092; 512 (B4) 0.8104 / 0.6208. Pairing wins within one wave and
//   loses by 1.22-1.31x from 1.45 waves on, hence the cut at grid <=
//   SMs. The warpgroup past its last key tile waits for and releases
//   the rest without products. Grid (B·H·slices, ceil(n / 2)).
// - S = Q·Kᵀ over 64-key tiles sums over D in 64-column chunks (m64n64k16
//   x 4 a chunk, both operands K-major [rows][64] boxes), a chunk a step
//   of one loop, every slice in the same order, so every slice forms the
//   same m and l (lse from slice 0); the S groups of consecutive steps
//   overlap (wgmma.wait_group 1).
// - A producer warpgroup (setmaxnreg 24 / 240) streams K chunks (8 KB)
//   through a ring of full/empty mbarriers, and a second of its warps
//   each key tile's V slice (OWN boxes of [64][64]), single-buffered:
//   loaded once the previous tile's P·V has read it, needed only after
//   the tile's nc S steps. Q stays resident (nc x 16 KB) where it fits
//   beside V and 6 stages, else Q chunks ride the ring with K: the ring
//   takes what is left, up to 16 stages: 8 at D 512 (Q 128 + V 32 + 8 x
//   8 = 224 KB), 7 at D 576, 8 of 24 KB past it (4 stages time the
//   same, 0.987-1.001x: the producer warpgroup, not the depth, keeps the
//   loads ahead of the consumers, none of whose warps waits for
//   another's release). Q streamed where it could stay costs 1.014x at D
//   384, 1.022-1.033x at D 512 on 128-512 CTAs and 1.046x at D 576
//   (knockout q_streamed).
// - P·V takes P from registers (bf16 at the running max, as below) and
//   V MN-major, OWN m64n64k16 products a K step. Registers: o OWN x 32 +
//   s 32 + P 16, as at D 256. The warpgroup index is broadcast from lane
//   0 (__shfl_sync), so ptxas sees the branches on it as uniform: on
//   tid / 128 it serialises every wgmma (C7518), 1.44x the time.
// - Cost: the score product is recomputed once per slice, so the
//   forward does slices + 1 half-products where one D-wide CTA would do
//   2 (3 at D 512, against the CUDA-core sliced kernel's 9).
//
// past D 256, the bf16 dq and dk/dv -> tensor cores, D sliced
// (tc::flash_dq_sliced_tc_kernel<OWN>, tc::flash_dkdv_sliced_tc_kernel<
// OWN>; D any multiple of 64, a runtime value; no D limit). dq is the
// sliced forward's walk with dP beside S; dk/dv gives the two products
// over D to the two warpgroups. The arithmetic that bounds them:
// - Registers. An f32 accumulator of a 64-row warpgroup costs 32
//   registers a thread per 64-column chunk, so a slice of OWN <= 4
//   chunks is at most 128. Beside it dq holds S (32), dP (32) and a bf16
//   dS fragment (16): 208 at OWN 4 under setmaxnreg 240, the producer
//   warpgroup keeping 24 (setmaxnreg moves registers only within the
//   CTA, out of the 168 a thread it holds at launch: 128 x 24 + 256 x
//   240 = 384 x 168; a consumer asking for more waits for ever). A dk/dv
//   warpgroup holds its accumulator, one 64 x 64 product (Sᵀ or dPᵀ, 32)
//   and a fragment (16): 176, under 232, so its three producer warps get
//   32 (at 24 they spilled). ptxas reports no spills.
// - Shared memory (232,448 bytes a block). At D 512 a 128-row Q plus dO
//   kept resident is 256 KB, so dq keeps Q resident only where it fits
//   beside the K slice (OWN x 8 KB) and kDqMinStages stages of K, V and
//   the dO chunk pair (32 KB): D 320 and 384; past that Q's chunk pair
//   rides the ring too (48 KB a stage, 4 stages at D 512). dk/dv streams
//   Q, dO, K and V chunks (32 KB a stage, 4 stages at D 512) beside the
//   Q and dO slices (2 x OWN x 8 KB) and the f32 Pᵀ tile (16 KB).
// - Work. With two slices at D 512, dq does 5 half-products (S and dP
//   per slice, dS·K[:, slice] once in all) where one D-wide CTA would do
//   3, dk/dv 6 (Sᵀ and dPᵀ per slice) against 4; the CUDA-core pair did
//   17 and 18 (the scores once per 64 columns). In dk/dv warpgroup 0
//   forms Sᵀ and warpgroup 1 dPᵀ, each 4 wgmma a chunk; warpgroup 0
//   hands Pᵀ in f32 to warpgroup 1 through shared memory (named barriers
//   1 and 2), so neither forms the other's product. Both forming Sᵀ, as
//   flash_dkdv_split_tc_kernel does at D <= 256, put 8 a chunk on
//   warpgroup 1 and took 1.34-1.39x the time for the same bits
//   (scripts/flash_ab.py against that version: 0.2418 against 0.1784 ms
//   at B2 S2048 H2 D512, 1.7702 against 1.2753 at B4 S4096; NVIDIA H100
//   80GB HBM3, 700 W).
// - Balance. dq pairs query tiles i and n - 1 - i as the forward does,
//   where the grid fits one wave of the SMs; past it 128 consecutive
//   rows a CTA, the heaviest first. dk/dv takes one key tile a CTA, the
//   heaviest (the lowest) first. The warpgroup index is broadcast from
//   lane 0, and dk/dv's two roles are two instances of one walk (no
//   wgmma under a branch on the role).
// scripts/flash_sliced_knockout.py (same card; causal bf16; each choice
// undone against the kept one): dq unpaired within one wave 1.089x at
// B2 S2048 D512 (1.194x at D 384), paired past it 1.32-1.38x; Q streamed
// where it can stay 1.026x at D 384 (1.013-1.049x over four runs);
// slices of 3 at D 512 1.04-1.44x (dq) and 1.33-1.36x (dk/dv); a 2-stage
// ring beside a resident Q 1.14-1.21x. In dk/dv (both warpgroups forming
// Sᵀ then), pairing key tiles as two passes of a CTA read 0.982x and
// 0.989x within one wave and 1.02-1.24x past it, and K and V resident at
// D 384 1.003x, so neither was kept.
// The rounding contract holds: P rounded to bf16 before Pᵀ·dO, dS from
// the unrounded P, rounded to bf16 before dS·K and dSᵀ·Q; sums in f32
// with the -1e9 finite mask.
//
// past D 256, the float32 forward, dq and dk/dv -> tensor cores in
// 3xTF32 (tc::flash_fwd_sliced_tf32_kernel<OWN>, tc::flash_dq_sliced_
// tf32_kernel<OWN>, tc::flash_dkdv_sliced_tf32_kernel<OWN>; D any
// multiple of 64, a runtime value; no D limit; all three also up to D
// 256, above). The backward pair first; the forward, which reuses its
// steps, after it, then the 128-row forward up to D 128.
// - Numbers. One TF32 product keeps 11 of f32's 24 bits: on sums over D
//   512 its gradients miss the f32 limits (1e-5, 1e-4) by 25-76x
//   (tests/test_torch_flash_attention.py's emulation). Each operand x
//   splits into hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact),
//   and hi·lo + lo·hi + hi·hi keeps about 22 bits (lo·lo, 2^-22 of the
//   product, is dropped): 0.05-0.12 of the limit there. Rounding is to
//   nearest, ties away from zero, as cvt.rna.tf32.f32, done in two
//   integer operations (to_tf32): the same bits as cvt.rna in 0.87-0.95x
//   the time (knockout cvt_round). P and dS stay f32 and split like any
//   other operand. A K step's 8 products reach the f32 accumulator
//   exactly enough (24 bits below the largest term), but the tensor
//   cores truncate toward zero what they write back, so a chain of
//   wgmma over all of D, or over the walked tiles, drifts toward zero
//   by a bit of the running sum at every step: the gradients missed the
//   limits by 1.25-6.3x (knockout chained_score) and up to 5.2x
//   (chained_out; scripts/flash_sliced_knockout.py --only tf32, NVIDIA
//   H100 80GB HBM3, 700 W, B2 S2048 to B4 S4096, D 512 and 1024, held
//   to the plain versions in float64). So every 2 K steps of 8 of a
//   score step and every 4 of an output step sum in a fresh
//   accumulator, added to the running one in f32, to nearest: 0.09-0.24
//   of the limits there (one fresh sum a score step, knockout
//   score_ks4, read the same). The low terms go first (knockout
//   hi_first: no difference seen). Where dS = P∘(dP - delta) cancels
//   (a causal row whose weight sits on one key), dP's own error shows
//   whole in dq and dk: there the f32 plain version, a sequential f32
//   FMA chain over D in cuBLAS, strays by up to 1.09 limits from the
//   exact function while these kernels stay within 0.16
//   (scripts/flash_ab.py --worst at B2 S2048 H2 D1024;
//   scripts/flash_tf32_model.py gives all three dP errors there), so the
//   checks hold them to the plain versions evaluated in float64.
//   Splitting dP's operands on each 8-column group's grid, so that its
//   hi·hi sums exactly (knockout dp_grid), took 1.12-1.37x the time and
//   erred more (0.10-0.47).
// - Roles. A CTA holds 64 rows (query rows for dq, keys for dk/dv) and
//   a slice of 64-column output chunks; warpgroup 0 forms the first score
//   product over D (S = Q·Kᵀ; Sᵀ = K·Qᵀ), warpgroup 1 the second (dP =
//   dO·Vᵀ; dPᵀ = V·dOᵀ), each from one [64][32] box of its A rows and the
//   walked tile's B rows a step. P (dq) or Pᵀ (dk/dv) goes to warpgroup 1
//   as tf32 parts in shared memory (named barrier 1; barrier 2 says they
//   were read); dq's warpgroup 1 puts dS in their place for both, dk/dv's
//   puts dSᵀ in tiles of its own. Both then add products with D as
//   output: dq splits its slice between the warpgroups (OWN chunks and
//   the rest), dk/dv gives dv to warpgroup 0 and dk to warpgroup 1.
// - Layouts. wgmma has transpose bits only for 16-bit types, so a tf32
//   operand in shared memory must be K-major. The score products take A
//   (this CTA's rows) from registers, split there from the raw box, and B
//   (the walked rows) K-major as TMA lands it: natural. The products with
//   D as output are formed transposed, dqᵀ = Kᵀ·dSᵀ, dvᵀ = dOᵀ·P, dkᵀ =
//   Qᵀ·dS: M is 64 output columns, read from the walked tile's raw box by
//   scalar loads into A's register fragments (any layout, split there),
//   and B is the P or dS parts, K-major as the accumulator's rows lay
//   them: no transposed copy of any operand, and the accumulator-to-A-
//   fragment mismatch of k8 steps (a thread holds columns 2t, 2t + 1 of
//   an accumulator but t, t + 4 of an A fragment) never arises. The
//   accumulators are the outputs' transposes, stored element-wise.
// - The split pass. The walked B boxes are needed as parts in shared
//   memory (wgmma reads them there). A pass before the kernel
//   (tf32_split_kernel) writes the parts of K and V (dq) or Q and dO
//   (dk/dv) to a workspace the wrapper allocates (4 floats an element),
//   and TMA brings hi and lo boxes: at B4 S4096 H2 D512 a dq call holds
//   320 MiB and a dk/dv call 384 MiB beyond its inputs, 256 of it the
//   workspace (chip_smoke.py's peak_mib). Converting in the kernel
//   instead (knockout split_in_kernel: TMA brings the B boxes raw and
//   each consumer warpgroup splits its box in shared memory before its
//   score step) took 1.40-2.16x the time: the conversion's
//   shared-memory traffic sits on the step's critical path. An earlier
//   form with three producer warps converting between TMA and the
//   consumers was slower as well (not kept). So was an mma.sync form of the D-output products (B split by every warp of a
//   warpgroup, the P or dS fragments from the accumulator with the k8
//   columns permuted): it spilled and its loads and splits were repeated
//   four times.
// - Shared memory (232,448 bytes). A stage is six [64][32] f32 boxes
//   (A0 raw, B0 hi, A1 raw, B1 hi, B0 lo, B1 lo: 48 KB; an output step
//   uses four raw boxes of it); dq keeps the P/dS parts (32 KB), dk/dv
//   Pᵀ's and dSᵀ's (64 KB) and the tile's lse and delta: rings of 4 and
//   3 stages.
// - Registers. A producer warpgroup (one TMA thread; dk/dv's second warp
//   stages lse and delta) at 24, the consumers at 240 (setmaxnreg; 128 x
//   24 + 256 x 240 = 384 x 168). A warpgroup holds OWN <= 4 chunks of
//   accumulator (128) beside the score tile (32), a fresh sum (32) and
//   A's parts of 2 K steps (16), or beside an output step's sum and the
//   parts of 4 of its 8 K steps (two commit groups: all 8 spilled more).
//   ptxas spills a little in the 4-chunk instantiations (chip_smoke.py
//   prints the bytes).
// - Slices. dq: the fewest slices of at most 8 chunks (D 512 is one), or
//   of 6 where that grid fits one wave of the SMs (the causal rows' work
//   evens out over more, lighter CTAs): warpgroup 0 takes ceil(own / 2)
//   chunks; dk/dv: sl_own's (4 + 4 at D 512). The other choices (same
//   card): slices of 8 whatever the grid 1.15x at B2 S2048 H2 D512 (one
//   wave), of 6 whatever the grid 1.32-1.38x past one wave; dk/dv slices
//   of 3 1.19-1.46x (knockouts dq_slices8, dq_slices6, dkdv_own3).
// - Work. dq does 3 half-products at D 512 (at B2 S2048 H2, one wave: 5),
//   dk/dv 6 (2 slices), each product three TF32 ones.
// The forward (flash_fwd_sliced_tf32_kernel<OWN>) is dq's walk without dP
// and dS, plus the online softmax, which dq does not need (it reads a
// finished lse):
// - Products. S = Q·Kᵀ is dq's score step (A, this CTA's 64 query rows,
//   split in registers from the raw box; B the K parts the split pass
//   wrote, by TMA). oᵀ = Vᵀ·Pᵀ is dq's output step: A the walked tile's V
//   columns from its raw box, B P's parts, K-major as the accumulator's
//   rows lay them. Fresh sums every 2 K steps of a score step and every 4
//   of an output step, as above: chained_score and chained_out read
//   0.31-0.67 and 0.34-0.61 of the forward's o limit against the kept
//   0.05-0.09 (the forward's S error does not cancel as dS's does), in
//   0.91-1.02x the time. P stays f32: its rounding "to v's dtype" is the
//   identity.
// - Roles. dq's two score products fill both warpgroups; the forward has
//   one. So each warpgroup sums half of it over D: score step j brings
//   columns 32·j for warpgroup 0 and 32·(D/64 + j) for warpgroup 1 (the
//   stage of six boxes is dq's), and warpgroup 1 hands its half to
//   warpgroup 0 through shared memory (16 KB, named barrier 1), which
//   adds it in f32. A warpgroup then does D/64 score steps a key tile
//   and OWN output steps, where dq's do D/32 and OWN. The other layouts
//   cost more: warpgroup 0 forming all of S leaves warpgroup 1 idle for
//   its D/32 steps (knockout fwd_whole_s; PERF.md's findings have its
//   time); warpgroups owning 64 rows each and slices of 4 chunks form S
//   twice at D 512.
// - The softmax hand-off. Warpgroup 0 holds the row max m and the row
//   sum l of its rows (as the score accumulator holds them: two rows a
//   thread, a lane quad a row), scales and masks the summed S, forms P =
//   exp(S - m_new) and α = exp(m_old - m_new), and puts P's parts and α
//   (f32 [64]) in shared memory under named barrier 2. In oᵀ the queries
//   are the accumulator's columns (a thread holds 8j + 2t and 8j + 2t +
//   1), so both warpgroups read α there and multiply their chunks by it
//   before the tile's output steps: oᵀ = oᵀ·α + Vᵀ·Pᵀ, the product in its
//   fresh sums. At the end warpgroup 0 puts 1 / l beside α (barrier 3)
//   and writes lse (slice 0). Forming S twice instead, first for m and l
//   and then P = exp(S - lse) with no rescale, costs one more score
//   product a tile; the rescale costs 32 multiplies a chunk and 16
//   shared loads a thread a tile.
// - Shared memory: the ring (3 stages of 48 KB), P's parts (32 KB),
//   warpgroup 1's half of S (16 KB, in two P/dS tile sets' room: a
//   fourth stage would not fit either way), α and 1 / l. Barrier 1
//   orders their reuse too: warpgroup 1 reaches it only past the
//   previous tile's output steps, and warpgroup 0 writes P and α only
//   past it.
// - Slices and work as dq's (one helper, tf_row_slices): one slice at D
//   320-512, two at 576-1024 and at D 512 where the grid fits one wave
//   (one slice there: 1.26x at B2 S2048 H2; two past one wave: 1.21-
//   1.29x; knockouts dq_slices8, dq_slices6).
//   At D 512 the forward does 2 half-products in one slice (the CUDA-core
//   kernel it replaced did 9: the scores once per 64 output columns):
//   2.24 against 26.52 ms at B4 S4096 H2, 0.38 against 3.38 at B2 S2048
//   (scripts/flash_ab.py, NVIDIA H100 80GB HBM3, 700 W). The split pass
//   writes K's parts alone (2 floats an element of K). At D 192 and 256
//   the kernel runs one slice of all of D (OWN 2: warpgroup 0 holds two
//   chunks of oᵀ, warpgroup 1 the other one or two).
// The forward up to D 128 (flash_fwd_rows_tf32_kernel<NC>) is dq_rows's
// walk without dP and dS. Each warpgroup forms S of its own 64 rows over
// all of D (D/32 score steps a key tile, where the sliced forward's
// warpgroups do D/64 each and add the halves in f32, so the bits
// differ), runs the online softmax above on it in registers and puts
// P's parts and α in a tile of its own (named barrier 1 + g over its
// 128 threads), then does NC output steps: no hand-off between the
// warpgroups, and K's parts come once a 128 rows.
// - Shared memory: a ring of 5 stages of 32 KB (a score step's two raw
//   Q boxes and K's high and low boxes; an output step a chunk of V's
//   columns, raw), the two warpgroups' P parts (64 KB), their α and 1 /
//   l (1 KB). Q streams with K: kept resident, 128 rows of D 128 in f32
//   would take 64 KB, two of the five stages.
// - Registers: oᵀ (NC x 32) beside S (32), a score step's fresh sum (32)
//   and A's parts (16), under the consumers' 240.
// - The warpgroup's barrier is taken before P and α are written as well
//   as after: a warp's wgmma wait covers the 16 rows of the product its
//   own, so a warp past its output steps could overwrite the P parts
//   another warp's output step still reads (at D 32 and 64 a key tile
//   has fewer steps than the ring has stages, so the ring does not hold
//   it back).
// The kernels allocate nothing; the Python wrapper allocates outputs
// and checks shapes, dtypes, contiguity and alignment.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"       // mbarriers, TMA, wgmma, tensor maps
#include "tf32.cuh"         // the 3xTF32 steps, ring and split pass

namespace {

constexpr float kMask = -1e9f;     // finite mask value, as the TPU kernel

// ===========================================================================
// bfloat16: tensor cores (wgmma), tiles by TMA
// ===========================================================================

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // two warpgroups of 128
constexpr int kRows = 128;         // rows a CTA owns (64 per warpgroup)
constexpr int kStages = 2;         // ring of walked tiles

// Past D 128 the tiles shrink to fit 227 KB of shared memory and 255
// registers a thread (header): the forward walks keys in tiles of 64, a
// dq CTA is one warpgroup of 64 query rows
__host__ __device__ constexpr int fwd_keys(int D) { return D > 128 ? 64 : 128; }
__host__ __device__ constexpr int dq_warpgroups(int D) {
  return D > 128 ? 1 : 2;
}

// 64-wide column chunks of a D-wide tile; D 32 is one chunk whose
// columns 32..63 TMA fills with zeros (the box reaches past D), so
// products over D take only the first D/16 K steps, and products with D
// as output give zero columns past D, which store_acc skips
__host__ __device__ constexpr int chunks(int D) { return (D + 63) / 64; }

// rows [s0, s0 + ROWS) of head h as chunks(D) boxes of [ROWS][64]
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int b, int h,
                                          int s0) {
#pragma unroll
  for (int c = 0; c < chunks(D); ++c)
    tma_load(dst + c * ROWS * kRowBytes, map, bar, c * 64, h, s0, b);
}

// a (B, S, H) f32 statistic at this thread's 16 accumulator columns
// q0 + acc_col(i, l) (0 past S), element i at v[2·(i/4) + i%2]
__device__ __forceinline__ void load_cols(float (&v)[16],
                                          const float* __restrict__ x,
                                          int b, int h, int q0, int S,
                                          int H, int l) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qpos = q0 + acc_col(4 * j + e, l);
      v[2 * j + e] =
          qpos < S ? x[(static_cast<int64_t>(b) * S + qpos) * H + h] : 0.f;
    }
}

// rows row0 and row0 + 8 (if below S) of a (B, S, H, D) bf16 output from
// the chunks(D) accumulators of a warpgroup, row r scaled by mul[r]
template <int D>
__device__ __forceinline__ void store_acc(bf16* out,
                                          const float (&acc)[chunks(D)][32],
                                          const float (&mul)[2], int b,
                                          int h, int row0, int S, int H,
                                          int l) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s >= S) continue;
    bf16* row = out + ((static_cast<int64_t>(b) * S + s) * H + h) * D;
#pragma unroll
    for (int c = 0; c < chunks(D); ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (64 * c + 8 * j >= D) continue;       // zero padding past D
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(row + 64 * c + acc_col(i, l)) =
            pack_bf16(acc[c][i] * mul[r], acc[c][i + 1] * mul[r]);
      }
  }
}

using Ring = hopper::Ring<kStages>;
template <int kFixedBytes, int kStageBytes>
using Layout = hopper::Layout<kStages, kFixedBytes, kStageBytes>;

// empty stages take one arrival per warp of the CTA's `threads`
__device__ __forceinline__ Ring make_ring(unsigned char* raw, int bars_at,
                                          int threads = kThreads) {
  return hopper::make_ring<kStages>(raw, bars_at, threads / 32);
}

// d (+)= A·B at N 64 or 128 (d: N/2 f32 a thread)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, a, b, acc);
  else
    wgmma_ss_n128(d, a, b, acc);
}

// ---------------------------------------------------------------------------
// forward: o and lse. CTA: 128 queries of one (b, h); K/V tiles of 128
// keys (64 past D 128).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qm,
                    const __grid_constant__ CUtensorMap km,
                    const __grid_constant__ CUtensorMap vm,
                    bf16* __restrict__ o, float* __restrict__ lse, int H,
                    int Sq, int Skv, float scale, int causal) {
  constexpr int kN = fwd_keys(D), kC = chunks(D);
  constexpr int kQ = kRows * kC * kRowBytes, kKV = kN * kC * kRowBytes;
  using L = Layout<kQ, 2 * kKV>;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, L::kBars);
  const uint32_t qs = ring.base, kv0 = ring.base + kQ;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int nk = (Skv + kN - 1) / kN;
  const int nkt =
      causal ? min(nk, (min(q0 + kRows, Sq) - 1) / kN + 1) : nk;
  const int tid = threadIdx.x, g = tid / 128, l = tid % 32;
  const int row0 = q0 + 64 * g + 16 * ((tid / 32) % 4) + l / 4;

  if (tid == 0) {
    bar_expect(ring.once(), kQ);
    load_rows<D, kRows>(qs, &qm, ring.once(), b, h, q0);
    for (int t = 0; t < min(kStages, nkt); ++t) {
      bar_expect(ring.full(t), 2 * kKV);
      load_rows<D, kN>(kv0 + t * 2 * kKV, &km, ring.full(t), b, h, t * kN);
      load_rows<D, kN>(kv0 + t * 2 * kKV + kKV, &vm, ring.full(t), b, h,
                       t * kN);
    }
  }
  __syncwarp();

  float acc[kC][32], m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kC; ++c) zero(acc[c]);
  warp_wait(ring.once(), 0);

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % kStages;
    // refill the stage tile kt - 1 used, once all warps released it
    if (tid == 0 && kt >= 1 && kt - 1 + kStages < nkt) {
      const int t = kt - 1 + kStages, s2 = t % kStages;
      bar_wait(ring.empty(s2), ((kt - 1) / kStages) & 1);
      bar_expect(ring.full(s2), 2 * kKV);
      load_rows<D, kN>(kv0 + s2 * 2 * kKV, &km, ring.full(s2), b, h, t * kN);
      load_rows<D, kN>(kv0 + s2 * 2 * kKV + kKV, &vm, ring.full(s2), b, h,
                       t * kN);
    }
    __syncwarp();
    warp_wait(ring.full(st), (kt / kStages) & 1);
    const uint32_t ks = kv0 + st * 2 * kKV;
    const uint32_t vs = ks + kKV;

    float s[kN / 2];
    zero(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(s, desc_k<kRows>(qs, 64 * g, kk), desc_k<kN>(ks, 0, kk),
                   kk > 0);
    wg_commit();
    wg_wait();
    keep(s);

    // scale, mask where the tile crosses the diagonal or the end
    const int k0 = kt * kN;
    const bool edge = (causal && k0 + kN - 1 > q0 + 64 * g) || k0 + kN > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      float x = s[i] * scale;
      if (edge) {
        const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
        x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
      }
      s[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      lsum[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      s[i] = expf(s[i] - m[(i % 4) / 2]);
      lsum[(i % 4) / 2] += s[i];           // this thread's part of the row
    }
    uint32_t pf[kN / 16][4];
    to_frags<kN / 16>(s, pf);             // p in bf16 at the running max
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i % 4) / 2];

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        wgmma_rs_n64(acc[c], pf[kk], desc_mn<kN>(vs, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < kC; ++c) keep(acc[c]);
    keep(pf);
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(st));
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(lsum[r]);
    inv[r] = 1.f / lsum[r];
  }
  store_acc<D>(o, acc, inv, b, h, row0, Sq, H, l);
  if (l % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = row0 + 8 * r;
      if (s < Sq)
        lse[(static_cast<int64_t>(b) * Sq + s) * H + h] =
            m[r] + logf(lsum[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq. CTA: 128 queries (64, one warpgroup, past D 128); K/V
// tiles of 64 keys.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128 * dq_warpgroups(D), 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap qm,
                   const __grid_constant__ CUtensorMap km,
                   const __grid_constant__ CUtensorMap vm,
                   const __grid_constant__ CUtensorMap dom,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int H, int Sq, int Skv, float scale, int causal) {
  constexpr int kN = 64, kC = chunks(D), kM = 64 * dq_warpgroups(D);
  constexpr int kQ = kM * kC * kRowBytes, kKV = kN * kC * kRowBytes;
  using L = Layout<2 * kQ, 2 * kKV>;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, L::kBars, 2 * kM);
  const uint32_t qs = ring.base, dos = qs + kQ, kv0 = dos + kQ;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int nk = (Skv + kN - 1) / kN;
  const int nkt =
      causal ? min(nk, (min(q0 + kM, Sq) - 1) / kN + 1) : nk;
  const int tid = threadIdx.x, g = tid / 128, l = tid % 32;
  const int row0 = q0 + 64 * g + 16 * ((tid / 32) % 4) + l / 4;

  if (tid == 0) {
    bar_expect(ring.once(), 2 * kQ);
    load_rows<D, kM>(qs, &qm, ring.once(), b, h, q0);
    load_rows<D, kM>(dos, &dom, ring.once(), b, h, q0);
    for (int t = 0; t < min(kStages, nkt); ++t) {
      bar_expect(ring.full(t), 2 * kKV);
      load_rows<D, kN>(kv0 + t * 2 * kKV, &km, ring.full(t), b, h, t * kN);
      load_rows<D, kN>(kv0 + t * 2 * kKV + kKV, &vm, ring.full(t), b, h,
                       t * kN);
    }
  }
  __syncwarp();

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * Sq + s) * H + h;
    row_lse[r] = s < Sq ? lse[at] : 0.f;
    row_delta[r] = s < Sq ? delta[at] : 0.f;
  }
  float acc[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c) zero(acc[c]);
  warp_wait(ring.once(), 0);

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % kStages;
    if (tid == 0 && kt >= 1 && kt - 1 + kStages < nkt) {
      const int t = kt - 1 + kStages, s2 = t % kStages;
      bar_wait(ring.empty(s2), ((kt - 1) / kStages) & 1);
      bar_expect(ring.full(s2), 2 * kKV);
      load_rows<D, kN>(kv0 + s2 * 2 * kKV, &km, ring.full(s2), b, h, t * kN);
      load_rows<D, kN>(kv0 + s2 * 2 * kKV + kKV, &vm, ring.full(s2), b, h,
                       t * kN);
    }
    __syncwarp();
    warp_wait(ring.full(st), (kt / kStages) & 1);
    const uint32_t ks = kv0 + st * 2 * kKV;
    const uint32_t vs = ks + kKV;

    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<kM>(qs, 64 * g, kk), desc_k<kN>(ks, 0, kk),
                   kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<kM>(dos, 64 * g, kk), desc_k<kN>(vs, 0, kk),
                   kk > 0);
    wg_commit();
    wg_wait();
    keep(s);
    keep(dp);

    const int k0 = kt * kN;
    const bool edge = (causal && k0 + kN - 1 > q0 + 64 * g) || k0 + kN > Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      float x = s[i] * scale;
      if (edge) {
        const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
        x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
      }
      const float p = expf(x - row_lse[r]);
      s[i] = p * (dp[i] - row_delta[r]) * scale;          // dS
    }
    uint32_t dsf[kN / 16][4];
    to_frags<kN / 16>(s, dsf);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        wgmma_rs_n64(acc[c], dsf[kk], desc_mn<kN>(ks, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < kC; ++c) keep(acc[c]);
    keep(dsf);
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(st));
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(dq, acc, one, b, h, row0, Sq, H, l);
}

// ---------------------------------------------------------------------------
// backward: dk and dv. CTA: 128 keys; Q/dO tiles of 64 queries.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qm,
                     const __grid_constant__ CUtensorMap km,
                     const __grid_constant__ CUtensorMap vm,
                     const __grid_constant__ CUtensorMap dom,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Skv,
                     float scale, int causal) {
  constexpr int kM = 64, kC = chunks(D);
  constexpr int kK = kRows * kC * kRowBytes, kQD = kM * kC * kRowBytes;
  using L = Layout<2 * kK, 2 * kQD>;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, L::kBars);
  const uint32_t ks = ring.base, vs = ks + kK, qd0 = vs + kK;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heavy tiles first
  const int nq = (Sq + kM - 1) / kM;
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? min(k0 / kM, nq) : 0;
  const int n = nq - qt0;
  const int tid = threadIdx.x, g = tid / 128, l = tid % 32;
  const int krow0 = k0 + 64 * g + 16 * ((tid / 32) % 4) + l / 4;

  if (tid == 0) {
    bar_expect(ring.once(), 2 * kK);
    load_rows<D, kRows>(ks, &km, ring.once(), b, h, k0);
    load_rows<D, kRows>(vs, &vm, ring.once(), b, h, k0);
    for (int t = 0; t < min(kStages, n); ++t) {
      bar_expect(ring.full(t), 2 * kQD);
      load_rows<D, kM>(qd0 + t * 2 * kQD, &qm, ring.full(t), b, h,
                       (qt0 + t) * kM);
      load_rows<D, kM>(qd0 + t * 2 * kQD + kQD, &dom, ring.full(t), b, h,
                       (qt0 + t) * kM);
    }
  }
  __syncwarp();

  float dka[kC][32], dva[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    zero(dka[c]);
    zero(dva[c]);
  }
  warp_wait(ring.once(), 0);

  for (int it = 0; it < n; ++it) {
    const int st = it % kStages;
    if (tid == 0 && it >= 1 && it - 1 + kStages < n) {
      const int t = it - 1 + kStages, s2 = t % kStages;
      bar_wait(ring.empty(s2), ((it - 1) / kStages) & 1);
      bar_expect(ring.full(s2), 2 * kQD);
      load_rows<D, kM>(qd0 + s2 * 2 * kQD, &qm, ring.full(s2), b, h,
                       (qt0 + t) * kM);
      load_rows<D, kM>(qd0 + s2 * 2 * kQD + kQD, &dom, ring.full(s2), b, h,
                       (qt0 + t) * kM);
    }
    __syncwarp();
    warp_wait(ring.full(st), (it / kStages) & 1);
    const uint32_t qs = qd0 + st * 2 * kQD;
    const uint32_t dos = qs + kQD;
    const int q0 = (qt0 + it) * kM;

    // Sᵀ = K·Qᵀ: rows are this warpgroup's keys, columns the queries
    float s[32];
    zero(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<kRows>(ks, 64 * g, kk), desc_k<kM>(qs, 0, kk),
                   kk > 0);
    wg_commit();
    float col[16];                          // lse, then delta, per column
    load_cols(col, lse, b, h, q0, Sq, H, l);   // in flight with the product
    wg_wait();
    keep(s);

    const bool edge = (causal && k0 + 64 * g + 63 > q0) || q0 + kM > Sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qpos = q0 + acc_col(i, l), kpos = krow0 + acc_row(i);
      float x = s[i] * scale;
      if (edge)
        x = qpos >= Sq ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
      s[i] = expf(x - col[2 * (i / 4) + i % 2]);
    }
    uint32_t pf[kM / 16][4];
    to_frags<kM / 16>(s, pf);             // pᵀ in bf16

    // dv += Pᵀ·dO, and dPᵀ = V·dOᵀ
    float dp[32];
    zero(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        wgmma_rs_n64(dva[c], pf[kk], desc_mn<kM>(dos, c, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<kRows>(vs, 64 * g, kk), desc_k<kM>(dos, 0, kk),
                   kk > 0);
    wg_commit();
    load_cols(col, delta, b, h, q0, Sq, H, l);
    wg_wait();
#pragma unroll
    for (int c = 0; c < kC; ++c) keep(dva[c]);
    keep(dp);
    keep(pf);

#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = s[i] * (dp[i] - col[2 * (i / 4) + i % 2]) * scale;   // dSᵀ
    uint32_t dsf[kM / 16][4];
    to_frags<kM / 16>(s, dsf);

    // dk += dSᵀ·Q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        wgmma_rs_n64(dka[c], dsf[kk], desc_mn<kM>(qs, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < kC; ++c) keep(dka[c]);
    keep(dsf);
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(st));
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(dk, dka, one, b, h, krow0, Skv, H, l);
  store_acc<D>(dv, dva, one, b, h, krow0, Skv, H, l);
}

// ---------------------------------------------------------------------------
// backward past D 128: dk and dv. CTA: 64 keys; Q/dO tiles of 64
// queries. Both warpgroups hold the same 64 keys and form the same
// Sᵀ = K·Qᵀ; warpgroup 0 accumulates dv += Pᵀ·dO, warpgroup 1 forms
// dPᵀ = V·dOᵀ and accumulates dk += dSᵀ·Q, each over all of D: one
// accumulator of chunks(D) x 32 registers a thread (128 at D 256), where
// the D <= 128 kernel's dk and dv together would need 256.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_split_tc_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm,
                           const __grid_constant__ CUtensorMap dom,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int H, int Sq, int Skv, float scale, int causal) {
  constexpr int kN = 64, kM = 64, kC = chunks(D);
  constexpr int kK = kN * kC * kRowBytes, kQD = kM * kC * kRowBytes;
  using L = Layout<2 * kK, 2 * kQD>;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = make_ring(smem_raw, L::kBars);
  const uint32_t ks = ring.base, vs = ks + kK, qd0 = vs + kK;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = (gridDim.y - 1 - blockIdx.y) * kN;    // heavy tiles first
  const int nq = (Sq + kM - 1) / kM;
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? min(k0 / kM, nq) : 0;
  const int n = nq - qt0;
  const int tid = threadIdx.x, g = tid / 128, l = tid % 32;
  const int krow0 = k0 + 16 * ((tid / 32) % 4) + l / 4;

  if (tid == 0) {
    bar_expect(ring.once(), 2 * kK);
    load_rows<D, kN>(ks, &km, ring.once(), b, h, k0);
    load_rows<D, kN>(vs, &vm, ring.once(), b, h, k0);
    for (int t = 0; t < min(kStages, n); ++t) {
      bar_expect(ring.full(t), 2 * kQD);
      load_rows<D, kM>(qd0 + t * 2 * kQD, &qm, ring.full(t), b, h,
                       (qt0 + t) * kM);
      load_rows<D, kM>(qd0 + t * 2 * kQD + kQD, &dom, ring.full(t), b, h,
                       (qt0 + t) * kM);
    }
  }
  __syncwarp();

  float acc[kC][32];                       // dv (warpgroup 0), dk (1)
#pragma unroll
  for (int c = 0; c < kC; ++c) zero(acc[c]);
  warp_wait(ring.once(), 0);

  for (int it = 0; it < n; ++it) {
    const int st = it % kStages;
    if (tid == 0 && it >= 1 && it - 1 + kStages < n) {
      const int t = it - 1 + kStages, s2 = t % kStages;
      bar_wait(ring.empty(s2), ((it - 1) / kStages) & 1);
      bar_expect(ring.full(s2), 2 * kQD);
      load_rows<D, kM>(qd0 + s2 * 2 * kQD, &qm, ring.full(s2), b, h,
                       (qt0 + t) * kM);
      load_rows<D, kM>(qd0 + s2 * 2 * kQD + kQD, &dom, ring.full(s2), b, h,
                       (qt0 + t) * kM);
    }
    __syncwarp();
    warp_wait(ring.full(st), (it / kStages) & 1);
    const uint32_t qs = qd0 + st * 2 * kQD;
    const uint32_t dos = qs + kQD;
    const int q0 = (qt0 + it) * kM;

    // Sᵀ = K·Qᵀ: rows are the CTA's keys, columns the queries
    float s[32];
    zero(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<kN>(ks, 0, kk), desc_k<kM>(qs, 0, kk), kk > 0);
    wg_commit();
    float col[16];                          // lse, then delta, per column
    load_cols(col, lse, b, h, q0, Sq, H, l);   // in flight with the product
    wg_wait();
    keep(s);

    const bool edge = (causal && k0 + kN - 1 > q0) || q0 + kM > Sq;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qpos = q0 + acc_col(i, l), kpos = krow0 + acc_row(i);
      float x = s[i] * scale;
      if (edge)
        x = qpos >= Sq ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
      s[i] = expf(x - col[2 * (i / 4) + i % 2]);
    }

    if (g == 0) {
      // dv += Pᵀ·dO
      uint32_t pf[kM / 16][4];
      to_frags<kM / 16>(s, pf);             // pᵀ in bf16
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          wgmma_rs_n64(acc[c], pf[kk], desc_mn<kM>(dos, c, kk));
      wg_commit();
      wg_wait();
#pragma unroll
      for (int c = 0; c < kC; ++c) keep(acc[c]);
      keep(pf);
    } else {
      // dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ - delta)·scale, dk += dSᵀ·Q
      float dp[32];
      zero(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<kN>(vs, 0, kk), desc_k<kM>(dos, 0, kk),
                     kk > 0);
      wg_commit();
      load_cols(col, delta, b, h, q0, Sq, H, l);
      wg_wait();
      keep(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = s[i] * (dp[i] - col[2 * (i / 4) + i % 2]) * scale;
      uint32_t dsf[kM / 16][4];
      to_frags<kM / 16>(s, dsf);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kC; ++c)
          wgmma_rs_n64(acc[c], dsf[kk], desc_mn<kM>(qs, c, kk));
      wg_commit();
      wg_wait();
#pragma unroll
      for (int c = 0; c < kC; ++c) keep(acc[c]);
      keep(dsf);
    }
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(st));
  }

  const float one[2] = {1.f, 1.f};
  store_acc<D>(g == 0 ? dv : dk, acc, one, b, h, krow0, Skv, H, l);
}

// ---------------------------------------------------------------------------
// forward past D 256 (header): CTA = two 64-row query tiles of one (b,
// h), a consumer warpgroup each — rows [128·y, + 128), the heaviest
// first, or where `paired`, tiles i and n - 1 - i of its n (so under the
// causal mask every CTA has the same work) — and one slice of OWN
// 64-column chunks of the output (grid (B·H·slices, ceil(n / 2)), the
// slice innermost), plus a producer warpgroup. Step t of the loop is
// (key tile t / nc, chunk t % nc) of the nc = D/64 chunks: S = Q·Kᵀ
// gains the chunk's product, both operands K-major [rows][64] boxes; K
// chunks (and Q chunks where Q is not resident) come through a ring of
// ns stages, every slice in the same chunk order, so every slice forms
// the same m and l. A key tile's V slice (OWN boxes of [64][64]) is
// loaded once the previous tile's P·V has read the buffer, and taken by
// P·V after the tile's last chunk. The key tiles are those of the later
// query tile; the other warpgroup waits for and releases the stages
// past its own last key tile without products. lse comes from slice 0.
// ---------------------------------------------------------------------------

constexpr int kSlConsumers = 256;  // two consumer warpgroups
constexpr int kSlThreads = kSlConsumers + 128;   // + the producer warpgroup
// setmaxnreg moves registers only within the CTA: the consumers' gain
// comes from what the producer warpgroup gives up, out of the 168 a
// thread (65536 / 384, a multiple of 8) the CTA holds at launch; a
// consumer asking for more waits for ever
constexpr int kSlProducerRegs = 24, kSlConsumerRegs = 240;
static_assert(128 * kSlProducerRegs + kSlConsumers * kSlConsumerRegs <=
                  kSlThreads * 168,
              "setmaxnreg counts must fit the registers held at launch");
constexpr int kSlMinStages = 6;    // ring of K (+ Q) chunks past D 256
constexpr int kSlMaxStages = 16;
constexpr int kSlKeys = 64;        // keys a tile past D 256
constexpr int kSlMaxChunks = 4;    // output chunks a slice: 256 columns
constexpr int kQChunk = kRows * kRowBytes;     // [128][64] bf16: 16 KB
constexpr int kKChunk = kSlKeys * kRowBytes;   // [64][64] bf16: 8 KB
constexpr int kSmemMax = 232448;   // bytes of shared memory a block may use

// Shared memory of the sliced forward: Q where resident (nc chunks), the
// V slice, the ring of ns stages, then barriers full[kSlMaxStages],
// empty[kSlMaxStages], vfull, vempty, qonce; 1024 bytes of alignment
__host__ __device__ constexpr int sl_q_bytes(int nc, bool q_res) {
  return q_res ? nc * kQChunk : 0;
}
__host__ __device__ constexpr int sl_stage_bytes(bool q_res) {
  return q_res ? kKChunk : kQChunk + kKChunk;
}
__host__ __device__ constexpr int sl_bars_at(int nc, int own, bool q_res,
                                             int ns) {
  return sl_q_bytes(nc, q_res) + own * kKChunk + ns * sl_stage_bytes(q_res);
}
__host__ __device__ constexpr size_t sl_smem(int nc, int own, bool q_res,
                                             int ns) {
  return 1024 + sl_bars_at(nc, own, q_res, ns) + 8 * (2 * kSlMaxStages + 3);
}

template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_fwd_sliced_tc_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int H, int Sq, int Skv, int D, int nsl, int q_res,
                           int ns, int paired, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 64;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base;                            // resident Q
  const uint32_t vb = base + sl_q_bytes(nc, q_res);    // [OWN][64][64]
  const uint32_t ring0 = vb + OWN * kKChunk;
  const int stage_bytes = sl_stage_bytes(q_res);
  const uint32_t bars = base + sl_bars_at(nc, OWN, q_res, ns);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSlMaxStages + s); };
  const uint32_t vfull = bars + 8 * 2 * kSlMaxStages;
  const uint32_t vempty = vfull + 8, qonce = vfull + 16;

  const int z = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H;
  const int col0 = 64 * OWN * z;
  // query tiles of 64 rows for warpgroups 0 and 1: i and n - 1 - i
  // where paired (where they are one tile, warpgroup 1 computes
  // nothing), else two consecutive ones, the heaviest first
  const int nq = (Sq + 63) / 64, tid = threadIdx.x, y = blockIdx.y;
  const int qa = paired ? 64 * y : 128 * (gridDim.y - 1 - y);
  const int qb = paired ? 64 * (nq - 1 - y) : qa + 64;
  const int nk = (Skv + kSlKeys - 1) / kSlKeys;
  auto tiles_of = [&](int q0) {            // key tiles rows [q0, + 64) see
    return causal ? min(nk, (min(q0 + 64, Sq) - 1) / kSlKeys + 1) : nk;
  };
  const int nkt = max(tiles_of(qa), tiles_of(qb));
  const int steps = nkt * nc;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kSlConsumers / 32);
    }
    bar_init(vfull, 1);
    bar_init(vempty, kSlConsumers / 32);
    bar_init(qonce, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kSlProducerRegs>();
    if (tid == kSlConsumers) {
      // Q (where resident), then every step's K chunk (and Q chunk) in
      // order, each stage once all eight consumer warps released it
      if (q_res) {
        bar_expect(qonce, nc * kQChunk);
        for (int c = 0; c < nc; ++c) {
          tma_load(qs + c * kQChunk, &qm, qonce, 64 * c, h, qa, b);
          tma_load(qs + c * kQChunk + kKChunk, &qm, qonce, 64 * c, h, qb, b);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int st = t % ns, c = t % nc;
        if (t >= ns) bar_wait(empty(st), (t / ns - 1) & 1);
        const uint32_t dst = ring0 + st * stage_bytes;
        bar_expect(full(st), stage_bytes);
        if (!q_res) {
          tma_load(dst + kKChunk, &qm, full(st), 64 * c, h, qa, b);
          tma_load(dst + 2 * kKChunk, &qm, full(st), 64 * c, h, qb, b);
        }
        tma_load(dst, &km, full(st), 64 * c, h, (t / nc) * kSlKeys, b);
      }
    } else if (tid == kSlConsumers + 32) {
      // each key tile's V slice, once the previous tile's P·V read it
      for (int kt = 0; kt < nkt; ++kt) {
        if (kt > 0) bar_wait(vempty, (kt - 1) & 1);
        bar_expect(vfull, OWN * kKChunk);
        for (int j = 0; j < OWN; ++j)
          tma_load(vb + j * kKChunk, &vm, vfull, col0 + 64 * j, h,
                   kt * kSlKeys, b);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kSlConsumerRegs>();

  // the warpgroup index broadcast from lane 0, so ptxas sees the branches
  // on it as warp-uniform (else it serialises the wgmma after them)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0), l = tid % 32;
  const int q0 = g == 0 ? qa : qb;
  const bool live = g == 0 || qb != qa;
  const int my_nkt = live ? tiles_of(q0) : 0;
  const int row0 = q0 + 16 * ((tid / 32) % 4) + l / 4;
  float acc[OWN][32], s[32], m[2] = {-INFINITY, -INFINITY};
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < OWN; ++j) zero(acc[j]);
  zero(s);
  if (q_res) warp_wait(qonce, 0);

  // released by a warp once the products that read the stage are done
  auto release = [&](int t) {
    __syncwarp();
    if (l == 0) bar_arrive(empty(t % ns));
  };
  for (int t = 0; t < steps; ++t) {
    const int kt = t / nc, c = t % nc, st = t % ns;
    warp_wait(full(st), (t / ns) & 1);
    if (kt >= my_nkt) {                     // past this warpgroup's keys:
      release(t);                           // keep the barriers' order
      if (c == nc - 1) {
        warp_wait(vfull, kt & 1);
        if (l == 0) bar_arrive(vempty);
      }
      continue;
    }
    const uint32_t stage = ring0 + st * stage_bytes;
    const uint32_t qc = q_res ? qs + c * kQChunk : stage + kKChunk;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(s, desc_k<kRows>(qc, 64 * g, kk),
                   desc_k<kSlKeys>(stage, 0, kk), c > 0 || kk > 0);
    wg_commit();
    if (c > 0) {                            // step t - 1's chunk is read
      wg_wait<1>();
      release(t - 1);
    }
    if (c < nc - 1) continue;
    wg_wait();
    keep(s);
    release(t);

    // scale, mask where the tile crosses the diagonal or the end
    const int k0 = kt * kSlKeys;
    const bool edge = (causal && k0 + kSlKeys - 1 > q0) || k0 + kSlKeys > Skv;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (edge) {
        const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
        x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
      }
      s[i] = x;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      lsum[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = expf(s[i] - m[(i % 4) / 2]);
      lsum[(i % 4) / 2] += s[i];           // this thread's part of the row
    }
    uint32_t pf[kSlKeys / 16][4];
    to_frags<kSlKeys / 16>(s, pf);        // p in bf16 at the running max
#pragma unroll
    for (int j = 0; j < OWN; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] *= corr[(i % 4) / 2];

    warp_wait(vfull, kt & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kSlKeys / 16; ++kk)
#pragma unroll
      for (int j = 0; j < OWN; ++j)
        wgmma_rs_n64(acc[j], pf[kk], desc_mn<kSlKeys>(vb, j, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < OWN; ++j) keep(acc[j]);
    keep(pf);
    __syncwarp();
    if (l == 0) bar_arrive(vempty);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(lsum[r]);
    inv[r] = 1.f / lsum[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_ = row0 + 8 * r;
    if (s_ >= Sq || !live) continue;
    bf16* row = o + ((static_cast<int64_t>(b) * Sq + s_) * H + h) * D;
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      if (col0 + 64 * j >= D) continue;    // the last slice's zero chunks
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * jj + 2 * r;
        *reinterpret_cast<uint32_t*>(row + col0 + 64 * j + acc_col(i, l)) =
            pack_bf16(acc[j][i] * inv[r], acc[j][i + 1] * inv[r]);
      }
    }
  }
  if (z == 0 && live && l % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s_ = row0 + 8 * r;
      if (s_ < Sq)
        lse[(static_cast<int64_t>(b) * Sq + s_) * H + h] =
            m[r] + logf(lsum[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq past D 256 (header): CTA = two 64-row query tiles of one (b, h), a
// consumer warpgroup each, paired as in the forward, and one slice of OWN
// 64-column chunks of dq (grid (B·H·slices, ceil(n / 2)), the slice
// innermost), plus a producer warpgroup. Step t is (key tile t / nc,
// chunk t % nc): S = Q·Kᵀ and dP = dO·Vᵀ gain the chunk's products, all
// four operands K-major [rows][64] boxes. A stage of the ring holds the
// step's K, V and dO chunks, and its Q chunks where Q is not resident
// (q_res). After a key tile's last chunk each warpgroup
// forms P = exp(S·scale - lse) and dS = P∘(dP - delta)·scale in
// registers, rounds dS to bf16 as the A operand and adds dS·K[:, slice],
// the key tile's K slice (OWN boxes of [64][64], MN-major) loaded, like
// the forward's V slice, once the previous tile's product has read the
// buffer.
// ---------------------------------------------------------------------------

// Shared memory of the sliced dq: Q where resident (nc chunks of
// [128][64]), the K slice, the ring of ns stages, then the barriers
// full[kSlMaxStages], empty[kSlMaxStages], kfull, kempty, qonce
__host__ __device__ constexpr int dq_stage_bytes(bool q_res) {
  return 2 * kKChunk + (q_res ? 1 : 2) * kQChunk;
}
__host__ __device__ constexpr int dq_bars_at(int nc, int own, bool q_res,
                                             int ns) {
  return sl_q_bytes(nc, q_res) + own * kKChunk + ns * dq_stage_bytes(q_res);
}
__host__ __device__ constexpr size_t dq_smem(int nc, int own, bool q_res,
                                             int ns) {
  return 1024 + dq_bars_at(nc, own, q_res, ns) + 8 * (2 * kSlMaxStages + 3);
}

template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_dq_sliced_tc_kernel(const __grid_constant__ CUtensorMap qm,
                          const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap vm,
                          const __grid_constant__ CUtensorMap dom,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int H, int Sq, int Skv,
                          int D, int nsl, int q_res, int ns, int paired,
                          float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 64;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base;                            // resident Q
  const uint32_t kb = qs + sl_q_bytes(nc, q_res);      // [OWN][64][64]
  const uint32_t ring0 = kb + OWN * kKChunk;
  const int stage_bytes = dq_stage_bytes(q_res);
  const uint32_t bars = base + dq_bars_at(nc, OWN, q_res, ns);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSlMaxStages + s); };
  const uint32_t kfull = bars + 8 * 2 * kSlMaxStages;
  const uint32_t kempty = kfull + 8, qonce = kfull + 16;

  const int z = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H;
  const int col0 = 64 * OWN * z;
  const int nq = (Sq + 63) / 64, tid = threadIdx.x, y = blockIdx.y;
  const int qa = paired ? 64 * y : 128 * (gridDim.y - 1 - y);
  const int qb = paired ? 64 * (nq - 1 - y) : qa + 64;
  const int nk = (Skv + kSlKeys - 1) / kSlKeys;
  auto tiles_of = [&](int q0) {            // key tiles rows [q0, + 64) see
    return causal ? min(nk, (min(q0 + 64, Sq) - 1) / kSlKeys + 1) : nk;
  };
  const int nkt = max(tiles_of(qa), tiles_of(qb));
  const int steps = nkt * nc;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kSlConsumers / 32);
    }
    bar_init(kfull, 1);
    bar_init(kempty, kSlConsumers / 32);
    bar_init(qonce, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kSlProducerRegs>();
    if (tid == kSlConsumers) {
      // Q (where resident), then every step's K, V and dO chunks (and
      // Q chunks) in order, each stage once all eight consumer warps
      // released it
      if (q_res) {
        bar_expect(qonce, nc * kQChunk);
        for (int c = 0; c < nc; ++c) {
          tma_load(qs + c * kQChunk, &qm, qonce, 64 * c, h, qa, b);
          tma_load(qs + c * kQChunk + kKChunk, &qm, qonce, 64 * c, h, qb, b);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int st = t % ns, c = t % nc, k0 = (t / nc) * kSlKeys;
        if (t >= ns) bar_wait(empty(st), (t / ns - 1) & 1);
        uint32_t dst = ring0 + st * stage_bytes;
        bar_expect(full(st), stage_bytes);
        tma_load(dst, &km, full(st), 64 * c, h, k0, b);
        tma_load(dst + kKChunk, &vm, full(st), 64 * c, h, k0, b);
        dst += 2 * kKChunk;
        tma_load(dst, &dom, full(st), 64 * c, h, qa, b);
        tma_load(dst + kKChunk, &dom, full(st), 64 * c, h, qb, b);
        if (!q_res) {
          tma_load(dst + kQChunk, &qm, full(st), 64 * c, h, qa, b);
          tma_load(dst + kQChunk + kKChunk, &qm, full(st), 64 * c, h, qb, b);
        }
      }
    } else if (tid == kSlConsumers + 32) {
      // each key tile's K slice, once the previous tile's dS·K read it
      for (int kt = 0; kt < nkt; ++kt) {
        if (kt > 0) bar_wait(kempty, (kt - 1) & 1);
        bar_expect(kfull, OWN * kKChunk);
        for (int j = 0; j < OWN; ++j)
          tma_load(kb + j * kKChunk, &km, kfull, col0 + 64 * j, h,
                   kt * kSlKeys, b);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kSlConsumerRegs>();

  // the warpgroup index broadcast from lane 0 (as in the forward)
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int l = tid % 32;
  const int q0 = g == 0 ? qa : qb;
  const bool live = g == 0 || qb != qa;
  const int my_nkt = live ? tiles_of(q0) : 0;
  const int row0 = q0 + 16 * ((tid / 32) % 4) + l / 4;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_ = row0 + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * Sq + s_) * H + h;
    row_lse[r] = live && s_ < Sq ? lse[at] : 0.f;
    row_delta[r] = live && s_ < Sq ? delta[at] : 0.f;
  }
  float acc[OWN][32], s[32], dp[32];
#pragma unroll
  for (int j = 0; j < OWN; ++j) zero(acc[j]);
  zero(s);
  zero(dp);
  if (q_res) warp_wait(qonce, 0);

  auto release = [&](int t) {
    __syncwarp();
    if (l == 0) bar_arrive(empty(t % ns));
  };
  for (int t = 0; t < steps; ++t) {
    const int kt = t / nc, c = t % nc, st = t % ns;
    warp_wait(full(st), (t / ns) & 1);
    if (kt >= my_nkt) {                     // past this warpgroup's keys:
      release(t);                           // keep the barriers' order
      if (c == nc - 1) {
        warp_wait(kfull, kt & 1);
        if (l == 0) bar_arrive(kempty);
      }
      continue;
    }
    const uint32_t stage = ring0 + st * stage_bytes;
    const uint32_t dc = stage + 2 * kKChunk;
    const uint32_t qc = q_res ? qs + c * kQChunk : dc + kQChunk;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(s, desc_k<kRows>(qc, 64 * g, kk),
                   desc_k<kSlKeys>(stage, 0, kk), c > 0 || kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(dp, desc_k<kRows>(dc, 64 * g, kk),
                   desc_k<kSlKeys>(stage + kKChunk, 0, kk), c > 0 || kk > 0);
    wg_commit();
    if (c > 0) {                            // step t - 1's chunks are read
      wg_wait<1>();
      release(t - 1);
    }
    if (c < nc - 1) continue;
    wg_wait();
    keep(s);
    keep(dp);
    release(t);

    // P from the scaled, masked scores, then dS in place of S
    const int k0 = kt * kSlKeys;
    const bool edge = (causal && k0 + kSlKeys - 1 > q0) || k0 + kSlKeys > Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i % 4) / 2;
      float x = s[i] * scale;
      if (edge) {
        const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
        x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
      }
      const float p = expf(x - row_lse[r]);
      s[i] = p * (dp[i] - row_delta[r]) * scale;
    }
    uint32_t dsf[kSlKeys / 16][4];
    to_frags<kSlKeys / 16>(s, dsf);         // dS in bf16

    warp_wait(kfull, kt & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kSlKeys / 16; ++kk)
#pragma unroll
      for (int j = 0; j < OWN; ++j)
        wgmma_rs_n64(acc[j], dsf[kk], desc_mn<kSlKeys>(kb, j, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < OWN; ++j) keep(acc[j]);
    keep(dsf);
    __syncwarp();
    if (l == 0) bar_arrive(kempty);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_ = row0 + 8 * r;
    if (s_ >= Sq || !live) continue;
    bf16* row = dq + ((static_cast<int64_t>(b) * Sq + s_) * H + h) * D;
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      if (col0 + 64 * j >= D) continue;    // the last slice's zero chunks
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int i = 4 * jj + 2 * r;
        *reinterpret_cast<uint32_t*>(row + col0 + 64 * j + acc_col(i, l)) =
            pack_bf16(acc[j][i], acc[j][i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk and dv past D 256 (header): CTA = 64 keys of one (b, h), the heaviest
// tiles first under the causal mask, and one slice of OWN 64-column
// chunks of dk and dv (grid (B·H·slices, key tiles), the slice
// innermost), plus a producer warpgroup. Step t is (query tile, chunk c):
// warpgroup 0 forms Sᵀ = K·Qᵀ over the chunks and warpgroup 1 dPᵀ =
// V·dOᵀ, from one stage of the ring holding the step's Q, dO, K and V
// chunks. After a query tile's last chunk warpgroup 0 forms Pᵀ and hands
// it, in f32, to warpgroup 1 through shared memory (named barriers 1 and
// 2, one each way), then adds Pᵀ·dO[:, slice] to dv; warpgroup 1 forms
// dSᵀ from it and adds dSᵀ·Q[:, slice] to dk. The Q and dO slices (OWN
// boxes of [64][64] each, MN-major) come from a second producer warp and
// the tile's lse and delta from a third, once the previous tile's
// products have read them. Each warpgroup holds one slice-wide
// accumulator.
// ---------------------------------------------------------------------------

// a consumer warpgroup's role in the sliced dk/dv, as a type
template <bool DK>
struct Role {
  static constexpr bool kDk = DK;
};

// Shared memory of the sliced dk/dv: the Q and dO slices, the ring of ns
// stages of Q, dO, K and V chunks, the f32 Pᵀ tile, the query tile's lse
// and delta (64 f32 each), then the barriers full[kSlMaxStages],
// empty[kSlMaxStages], sfull, sempty
constexpr int kDkdvStageBytes = 4 * kKChunk;
// three producer warps with loops of their own: at 24 registers they
// spilled, at 32 none does, and the consumers (176 registers of
// accumulators and fragments) fit 232
constexpr int kDkdvProducerRegs = 32, kDkdvConsumerRegs = 232;
static_assert(128 * kDkdvProducerRegs + kSlConsumers * kDkdvConsumerRegs <=
                  kSlThreads * 168,
              "setmaxnreg counts must fit the registers held at launch");
constexpr int kPBytes = 64 * 64 * 4;
constexpr int kStatBytes = 2 * 64 * 4;
__host__ __device__ constexpr int dkdv_bars_at(int own, int ns) {
  return 2 * own * kKChunk + ns * kDkdvStageBytes + kPBytes + kStatBytes;
}
__host__ __device__ constexpr size_t dkdv_smem(int own, int ns) {
  return 1024 + dkdv_bars_at(own, ns) + 8 * (2 * kSlMaxStages + 2);
}

template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_dkdv_sliced_tc_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const __grid_constant__ CUtensorMap dom,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, int Sq, int Skv, int D, int nsl, int ns,
                            float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 64;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qsl = base;                           // [OWN][64][64]
  const uint32_t dosl = qsl + OWN * kKChunk;
  const uint32_t ring0 = dosl + OWN * kKChunk;
  const uint32_t bars = base + dkdv_bars_at(OWN, ns);
  const uint32_t stats = bars - kStatBytes;  // lse, then delta: f32 [64]
  const uint32_t pbuf = stats - kPBytes;     // Pᵀ: f32 [8][128 threads][4]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSlMaxStages + s); };
  const uint32_t sfull = bars + 8 * 2 * kSlMaxStages, sempty = sfull + 8;

  const int z = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H;
  const int col0 = 64 * OWN * z, k0 = kSlKeys * blockIdx.y;
  const int nq = (Sq + 63) / 64, tid = threadIdx.x;
  // causal: query tiles wholly before the key tile see none of its keys
  const int qt0 = causal ? min(static_cast<int>(blockIdx.y), nq) : 0;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kSlConsumers / 32);
    }
    bar_init(sfull, 2);                    // the slices' TMA, the stats
    bar_init(sempty, kSlConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kDkdvProducerRegs>();
    if (tid == kSlConsumers) {
      // every step's Q, dO, K and V chunks in order, each stage once all
      // eight consumer warps released it
      for (int t = 0; t < (nq - qt0) * nc; ++t) {
        const int st = t % ns, c = t % nc, q0 = 64 * (qt0 + t / nc);
        if (t >= ns) bar_wait(empty(st), (t / ns - 1) & 1);
        const uint32_t dst = ring0 + st * kDkdvStageBytes;
        bar_expect(full(st), kDkdvStageBytes);
        tma_load(dst, &qm, full(st), 64 * c, h, q0, b);
        tma_load(dst + kKChunk, &dom, full(st), 64 * c, h, q0, b);
        tma_load(dst + 2 * kKChunk, &km, full(st), 64 * c, h, k0, b);
        tma_load(dst + 3 * kKChunk, &vm, full(st), 64 * c, h, k0, b);
      }
    } else if (tid == kSlConsumers + 32) {
      // each query tile's Q and dO slices, once the previous tile's
      // products read them
      for (int qt = qt0; qt < nq; ++qt) {
        if (qt > qt0) bar_wait(sempty, (qt - qt0 - 1) & 1);
        bar_expect(sfull, 2 * OWN * kKChunk);
        for (int j = 0; j < OWN; ++j) {
          tma_load(qsl + j * kKChunk, &qm, sfull, col0 + 64 * j, h, 64 * qt,
                   b);
          tma_load(dosl + j * kKChunk, &dom, sfull, col0 + 64 * j, h,
                   64 * qt, b);
        }
      }
    } else if (tid / 32 == kSlConsumers / 32 + 2) {
      // and its lse and delta (0 past Sq): the warp's stores, then lane
      // 0's arrival (a release) on sfull
      const int ln = tid % 32;
      const float* const lse_bh = lse + static_cast<int64_t>(b) * Sq * H + h;
      const float* const delta_bh =
          delta + static_cast<int64_t>(b) * Sq * H + h;
      for (int qt = qt0; qt < nq; ++qt) {
        if (qt > qt0) bar_wait(sempty, (qt - qt0 - 1) & 1);
        for (int i = 64 * qt + ln; i < 64 * qt + 64; i += 32) {
          const uint32_t at = stats + 4 * (i - 64 * qt);
          st_shared(at, i < Sq ? lse_bh[static_cast<int64_t>(i) * H] : 0.f);
          st_shared(at + 4 * 64,
                    i < Sq ? delta_bh[static_cast<int64_t>(i) * H] : 0.f);
        }
        __threadfence_block();
        __syncwarp();
        if (ln == 0) bar_arrive(sfull);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kDkdvConsumerRegs>();

  const int l = tid % 32;
  const int krow = 16 * ((tid / 32) % 4) + l / 4;     // of the 64 keys
  // one consumer warpgroup's walk: dv (DK false, warpgroup 0) or dk (DK
  // true, warpgroup 1), so no wgmma sits under a branch on the role
  auto consume = [&](auto role) {
    constexpr bool DK = decltype(role)::kDk;
    // this thread's slot of the Pᵀ tile: both warpgroups hold a 64 x 64
    // accumulator in one layout, so thread i of warpgroup 1 reads what
    // thread i of warpgroup 0 wrote
    const uint32_t pslot = pbuf + 16 * (tid % 128);
    float acc[OWN][32], s[32];             // s: Sᵀ (dv) or dPᵀ (dk)
#pragma unroll
    for (int j = 0; j < OWN; ++j) zero(acc[j]);
    zero(s);
    // the ring walked with counters, not with t % ns and t / ns
    // (divisions by runtime values): the step's stage and its phase, the
    // previous step's stage, and the phase of the slice buffer
    int st = 0, ph = 0, prev = 0, sph = 0;
    auto release = [&](int stage_index) {
      __syncwarp();
      if (l == 0) bar_arrive(empty(stage_index));
    };
    for (int q0 = 64 * qt0; q0 < Sq; q0 += 64) {
      for (int c = 0; c < nc; ++c) {
        warp_wait(full(st), ph);
        const uint32_t stage = ring0 + st * kDkdvStageBytes;
        // K·Qᵀ, or V·dOᵀ: the stage holds Q, dO, K, V
        const uint32_t a = stage + (DK ? 3 : 2) * kKChunk;
        const uint32_t bt = stage + (DK ? kKChunk : 0);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(s, desc_k<kSlKeys>(a, 0, kk), desc_k<64>(bt, 0, kk),
                       c > 0 || kk > 0);
        wg_commit();
        if (c > 0) {                        // the previous step's chunks
          wg_wait<1>();                     // are read
          release(prev);
        }
        prev = st;
        if (++st == ns) {
          st = 0;
          ph ^= 1;
        }
        if (c < nc - 1) continue;
        wg_wait();
        keep(s);
        release(prev);
        warp_wait(sfull, sph);              // the slices, lse and delta
        sph ^= 1;

        if constexpr (!DK) {
          // Pᵀ from the scaled, masked scores: rows keys, columns queries
          const bool edge =
              (causal && k0 + kSlKeys - 1 > q0) || q0 + 64 > Sq;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qpos = q0 + acc_col(i, l);
            const int kpos = k0 + krow + acc_row(i);
            float x = s[i] * scale;
            if (edge)
              x = qpos >= Sq ? -INFINITY
                  : (causal && kpos > qpos) ? kMask : x;
            s[i] = expf(x - ld_shared(stats + 4 * acc_col(i, l)));
          }
          // hand Pᵀ over once warpgroup 1 has read the previous tile's
          if (q0 > 64 * qt0) named_sync(2, kSlConsumers);
#pragma unroll
          for (int v = 0; v < 8; ++v)
            st_shared4(pslot + 2048 * v, s[4 * v], s[4 * v + 1],
                       s[4 * v + 2], s[4 * v + 3]);
          named_arrive(1, kSlConsumers);
        } else {
          // dSᵀ = Pᵀ∘(dPᵀ - delta)·scale, Pᵀ from warpgroup 0, unrounded
          named_sync(1, kSlConsumers);
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            float pv[4];
            ld_shared4(pslot + 2048 * v, pv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * v + e;
              s[i] = pv[e] *
                     (s[i] - ld_shared(stats + 4 * (64 + acc_col(i, l)))) *
                     scale;
            }
          }
          if (q0 + 64 < Sq) named_arrive(2, kSlConsumers);
        }
        uint32_t f[4][4];                  // pᵀ (dv) or dSᵀ (dk) in bf16
        to_frags<4>(s, f);
        // dv += Pᵀ·dO[:, slice], or dk += dSᵀ·Q[:, slice]
        const uint32_t sl = DK ? qsl : dosl;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < OWN; ++j)
            wgmma_rs_n64(acc[j], f[kk], desc_mn<64>(sl, j, kk));
        wg_commit();
        wg_wait();
#pragma unroll
        for (int j = 0; j < OWN; ++j) keep(acc[j]);
        keep(f);
        __syncwarp();
        if (l == 0) bar_arrive(sempty);
      }
    }
    bf16* const out = DK ? dk : dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s_ = k0 + krow + 8 * r;
      if (s_ >= Skv) continue;
      bf16* row = out + ((static_cast<int64_t>(b) * Skv + s_) * H + h) * D;
#pragma unroll
      for (int j = 0; j < OWN; ++j) {
        if (col0 + 64 * j >= D) continue;  // the last slice's zero chunks
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 4 * jj + 2 * r;
          *reinterpret_cast<uint32_t*>(row + col0 + 64 * j + acc_col(i, l)) =
              pack_bf16(acc[j][i], acc[j][i + 1]);
        }
      }
    }
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

// ---------------------------------------------------------------------------
// float32 dk/dv at every head dim and dq past D 128 (up to it, the
// 128-row dq below): 3xTF32 on the tensor cores (header). A CTA holds 64
// rows (query rows for dq, keys for dk/dv) and one slice of the output's
// 64-column chunks (all of them up to D 256),
// and walks the other side's 64-row tiles. Per tile the ring brings nc =
// D/32 score steps (six f32 boxes of [64][32]: this CTA's A rows, raw,
// and the walked tile's B rows of both score products as their tf32 high
// and low parts, which a pass before the kernel wrote to a workspace) and
// then OWN output steps (four raw boxes: a 64-column chunk of the walked
// tile for each warpgroup; at D 32 two, the chunk's first half).
// Warpgroup 0 forms the first score product (dq: S = Q·Kᵀ; dk/dv: Sᵀ =
// K·Qᵀ), warpgroup 1 the second (dP = dO·Vᵀ; dPᵀ = V·dOᵀ); P and dS pass
// between them through shared memory, as tf32 parts, under named
// barriers; then each accumulates its chunks of the output's transpose
// (dqᵀ = Kᵀ·dSᵀ, dvᵀ = dOᵀ·P, dkᵀ = Qᵀ·dS) with wgmma, A the walked
// tile's columns from registers and B the P or dS parts.
// ---------------------------------------------------------------------------

// shared memory: the ring of ns stages; `outs` tiles of P or dS parts
// (hi, then lo: [64 rows][64] as two [64][32] tiles each); the walked
// tile's lse and delta; then the barriers full[kTfMaxStages],
// empty[kTfMaxStages], sfull, sempty (tf32.cuh's TfRing and tf_init)
__host__ __device__ constexpr int tf_bars_at(int ns, int outs) {
  return ns * kTfStage + outs * 4 * kTfBox + kStatBytes;
}
__host__ __device__ constexpr size_t tf_smem(int ns, int outs) {
  return 1024 + tf_bars_at(ns, outs) + 8 * (2 * kTfMaxStages + 2);
}

// the rows of a (B, S, H, D) f32 output from `mine` of a warpgroup's OWN
// transposed accumulators (tf_out_step's), chunk j at column col + 64·j,
// rows row0 + n below S (columns past D skipped: whole chunks past it in
// a last slice, half of the one chunk at head dim 32)
template <int OWN>
__device__ __forceinline__ void tf_store(float* out,
                                         const float (&acc)[OWN][32],
                                         int mine, int b, int h, int row0,
                                         int col, int S, int H, int D) {
  const int i = threadIdx.x % 128, l = i % 32;
  const int m = 16 * (i / 32) + l / 4;
#pragma unroll
  for (int j = 0; j < OWN; ++j) {
    if (j >= mine) continue;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int s_ = row0 + acc_col(e, l), c = col + 64 * j + m + acc_row(e);
      if (s_ < S && c < D)
        out[((static_cast<int64_t>(b) * S + s_) * H + h) * D + c] = acc[j][e];
    }
  }
}

// a score step's six boxes at column c: A rows of both warpgroups (raw, at
// rows a0), B rows (the walked tile's, at rows w0) as high and low parts
__device__ __forceinline__ void tf_load_score(
    uint32_t dst, uint32_t bar, int c, int h, int a0, int w0, int b,
    const CUtensorMap* a_0, const CUtensorMap* b0h, const CUtensorMap* b0l,
    const CUtensorMap* a_1, const CUtensorMap* b1h, const CUtensorMap* b1l) {
  tma_load(dst, a_0, bar, 32 * c, h, a0, b);
  tma_load(dst + kTfBox, b0h, bar, 32 * c, h, w0, b);
  tma_load(dst + 2 * kTfBox, a_1, bar, 32 * c, h, a0, b);
  tma_load(dst + 3 * kTfBox, b1h, bar, 32 * c, h, w0, b);
  tma_load(dst + 4 * kTfBox, b0l, bar, 32 * c, h, w0, b);
  tma_load(dst + 5 * kTfBox, b1l, bar, 32 * c, h, w0, b);
}

// oᵀ's accumulators (columns: this CTA's 64 query rows) times one factor
// a query, f32 [64] at `at`: a thread's columns 8·jj + 2·(l % 4) + {0, 1}
template <int OWN>
__device__ __forceinline__ void tf_scale_cols(float (&acc)[OWN][32],
                                              uint32_t at) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float f[2];
    ld_shared2(at + 4 * (8 * jj + 2 * t), f);
#pragma unroll
    for (int j = 0; j < OWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][4 * jj + e] *= f[e % 2];
  }
}

// The forward: CTA = 64 query rows of one (b, h), the heaviest first, and
// a slice of `own` 64-column chunks of o (grid (B·H·slices, ceil(Sq /
// 64)), the slice innermost): warpgroup 0 accumulates the slice's first
// OWN chunks of oᵀ, warpgroup 1 the other own - OWN. Score step j of a
// key tile (j < nh = D / 64) holds the Q box, raw, and the K parts of
// columns 32·j for warpgroup 0 and of columns 32·(nh + j) for warpgroup
// 1: each sums its half of S = Q·Kᵀ over D. Warpgroup 1 hands its half to
// warpgroup 0 (named barrier 1), which adds it, scales and masks, runs
// the online softmax (row max m and sum l in registers, rows as the
// accumulator holds them) and puts P's parts and each row's rescale
// factor α = exp(m_old - m_new) in shared memory (barrier 2). Both then
// multiply their chunks of oᵀ, whose columns are the queries, by α and
// add Vᵀ·Pᵀ over output step p's V columns. Every slice sums S in the
// same order, so forms the same m and l: lse from slice 0. Barrier 1
// also orders the reuse of the shared tiles: warpgroup 1 reaches it only
// past the previous tile's output steps, and warpgroup 0 writes the next
// P and α only past it.
template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_fwd_sliced_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                             const __grid_constant__ CUtensorMap vm,
                             const __grid_constant__ CUtensorMap khm,
                             const __grid_constant__ CUtensorMap klm,
                             float* __restrict__ o, float* __restrict__ lse,
                             int H, int Sq, int Skv, int D, int nsl, int own,
                             int ns, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nh = D / 64;                   // score steps a key tile
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kTfStage;      // P's parts
  const uint32_t xs = xb + 4 * kTfBox;     // warpgroup 1's half of S
  const uint32_t stats = xb + 8 * kTfBox;  // α, then 1 / l: f32 [64]
  TfRing ring{base, base + tf_bars_at(ns, 2), ns};

  const int z = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const int col0 = 64 * own * z;
  const int q0 = 64 * (gridDim.y - 1 - blockIdx.y);    // heaviest first
  const int nk = (Skv + kSlKeys - 1) / kSlKeys;
  const int nkt =
      causal ? min(nk, (min(q0 + 64, Sq) - 1) / kSlKeys + 1) : nk;
  const int rest = own - OWN;              // warpgroup 1's chunks
  tf_init(ring.bars, ns);

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kSlConsumers) {
      int t = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * kSlKeys;
        for (int j = 0; j < nh; ++j, ++t, ring.next()) {
          const uint32_t dst = ring.acquire(t, kTfStage);
          for (int g = 0; g < 2; ++g) {
            const int c = 32 * (j + nh * g);
            tma_load(dst + 2 * g * kTfBox, &qm, ring.full(), c, h, q0, b);
            tma_load(dst + (2 * g + 1) * kTfBox, &khm, ring.full(), c, h,
                     k0, b);
            tma_load(dst + (4 + g) * kTfBox, &klm, ring.full(), c, h, k0,
                     b);
          }
        }
        for (int p = 0; p < OWN; ++p, ++t, ring.next()) {
          const bool two = p < rest;
          const uint32_t dst = ring.acquire(t, (two ? 4 : 2) * kTfBox);
          for (int g = 0; g < (two ? 2 : 1); ++g)
            for (int e = 0; e < 2; ++e)
              tma_load(dst + (2 * g + e) * kTfBox, &vm, ring.full(),
                       col0 + 64 * (OWN * g + p) + 32 * e, h, k0, b);
        }
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  const int l = tid % 32;
  const int row0 = q0 + 16 * ((tid / 32) % 4) + l / 4;
  auto consume = [&](auto role) {
    constexpr int G = decltype(role)::kDk ? 1 : 0;
    const int mine = G ? rest : OWN;
    float acc[OWN][32], s[32];
    float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < OWN; ++j) zero(acc[j]);
    zero(s);
    for (int kt = 0; kt < nkt; ++kt) {
      for (int j = 0; j < nh; ++j) {
        const uint32_t st = ring.wait();
        tf_score_step(s, st + 2 * G * kTfBox, st + (2 * G + 1) * kTfBox,
                      st + (4 + G) * kTfBox, j == 0);
        ring.release();
      }
      if constexpr (G == 1) {
        tf_give(xs, s);                    // this half of S, then wait
        named_arrive(1, kSlConsumers);     // for P
        named_sync(2, kSlConsumers);
      } else {
        named_sync(1, kSlConsumers);
        tf_take(s, xs);
        // scale, mask where the tile crosses the diagonal or the end
        const int k0 = kt * kSlKeys;
        const bool edge =
            (causal && k0 + kSlKeys - 1 > q0) || k0 + kSlKeys > Skv;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = s[i] * scale;
          if (edge) {
            const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
            x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
          }
          s[i] = x;
          mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = expf(m[r] - m_new);
          m[r] = m_new;
          lsum[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = expf(s[i] - m[(i % 4) / 2]);
          lsum[(i % 4) / 2] += s[i];       // this thread's part of the row
        }
        tf_put(xb, xb + 2 * kTfBox, s);
        if (l % 4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_shared(stats + 4 * (row0 - q0 + 8 * r), alpha[r]);
        }
        fence_proxy_async();
        named_sync(2, kSlConsumers);
      }
      tf_scale_cols<OWN>(acc, stats);     // oᵀ at the new running max
#pragma unroll
      for (int p = 0; p < OWN; ++p) {
        const uint32_t tile = ring.wait() + 2 * G * kTfBox;
        if (p < mine) tf_out_step(acc[p], tile, xb, xb + 2 * kTfBox);
        ring.release();
      }
    }
    // 1 / l of each row from warpgroup 0 (barrier 3), which writes lse
    if constexpr (G == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s_ = row0 + 8 * r;
        lsum[r] = quad_sum(lsum[r]);
        if (l % 4 == 0) {
          st_shared(stats + 4 * (64 + s_ - q0), 1.f / lsum[r]);
          if (z == 0 && s_ < Sq)
            lse[(static_cast<int64_t>(b) * Sq + s_) * H + h] =
                m[r] + logf(lsum[r]);
        }
      }
    }
    named_sync(3, kSlConsumers);
    tf_scale_cols<OWN>(acc, stats + 4 * 64);
    tf_store<OWN>(o, acc, mine, b, h, q0, col0 + 64 * OWN * G, Sq, H, D);
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

// dq: CTA = 64 query rows of one (b, h), the heaviest first, and a slice
// of `own` 64-column chunks of dq (grid (B·H·slices, ceil(Sq / 64)), the
// slice innermost): warpgroup 0 accumulates the slice's first OWN
// chunks, warpgroup 1 the other own - OWN. A score step holds the Q, K,
// dO and V boxes of (key tile, 32 columns); output step p the key tile's
// K columns of each warpgroup's chunk p. Warpgroup 0 forms P and puts it
// in the P/dS tiles; warpgroup 1 reads it, forms dS = P∘(dP -
// delta)·scale and puts it in the same tiles; both add Kᵀ·dSᵀ to their
// chunks of dqᵀ. Warpgroup 0 writes the next tile's P only once
// warpgroup 1's output steps have read this tile's dS (named barrier 3:
// at head dim 64 and 32, where the knockout dq_handoff runs this kernel
// in place of the 128-row one, a key tile has fewer score steps than the
// ring has stages, so the ring alone does not hold warpgroup 0 back).
// At head dim 32 a chunk is half a chunk: output steps load and use its
// first 32 columns (`halves`).
template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_dq_sliced_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap dom,
                            const __grid_constant__ CUtensorMap khm,
                            const __grid_constant__ CUtensorMap klm,
                            const __grid_constant__ CUtensorMap vhm,
                            const __grid_constant__ CUtensorMap vlm,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int H, int Sq, int Skv,
                            int D, int nsl, int own, int ns, float scale,
                            int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 32, halves = D % 64 ? 1 : 2;  // 32-column tiles a chunk
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kTfStage;      // P, then dS, parts
  TfRing ring{base, base + tf_bars_at(ns, 1), ns};

  const int z = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const int col0 = 64 * own * z;
  const int q0 = 64 * (gridDim.y - 1 - blockIdx.y);    // heaviest first
  const int nk = (Skv + kSlKeys - 1) / kSlKeys;
  const int nkt =
      causal ? min(nk, (min(q0 + 64, Sq) - 1) / kSlKeys + 1) : nk;
  const int rest = own - OWN;              // warpgroup 1's chunks
  tf_init(ring.bars, ns);

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kSlConsumers) {
      int t = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * kSlKeys;
        for (int c = 0; c < nc; ++c, ++t, ring.next())
          tf_load_score(ring.acquire(t, kTfStage), ring.full(), c, h, q0,
                        k0, b, &qm, &khm, &klm, &dom, &vhm, &vlm);
        for (int p = 0; p < OWN; ++p, ++t, ring.next()) {
          const bool two = p < rest;
          const uint32_t dst =
              ring.acquire(t, (two ? 2 : 1) * halves * kTfBox);
          for (int g = 0; g < (two ? 2 : 1); ++g)
            for (int e = 0; e < halves; ++e)
              tma_load(dst + (2 * g + e) * kTfBox, &km, ring.full(),
                       col0 + 64 * (OWN * g + p) + 32 * e, h, k0, b);
        }
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  const int l = tid % 32;
  const int row0 = q0 + 16 * ((tid / 32) % 4) + l / 4;
  auto consume = [&](auto role) {
    constexpr int G = decltype(role)::kDk ? 1 : 0;
    const int mine = G ? rest : OWN;
    float stat[2];                         // lse (warpgroup 0), delta (1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s_ = row0 + 8 * r;
      stat[r] = s_ < Sq ? (G ? delta : lse)[(static_cast<int64_t>(b) * Sq +
                                             s_) * H + h]
                        : 0.f;
    }
    float acc[OWN][32], s[32];
#pragma unroll
    for (int j = 0; j < OWN; ++j) zero(acc[j]);
    zero(s);
    for (int kt = 0; kt < nkt; ++kt) {
      for (int c = 0; c < nc; ++c) {
        const uint32_t st = ring.wait();
        tf_score_step(s, st + 2 * G * kTfBox, st + (2 * G + 1) * kTfBox,
                      st + (4 + G) * kTfBox, c == 0);
        ring.release();
      }
      if constexpr (G == 0) {
        // P from the scaled, masked scores, then dS from warpgroup 1
        const int k0 = kt * kSlKeys;
        const bool edge =
            (causal && k0 + kSlKeys - 1 > q0) || k0 + kSlKeys > Skv;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = s[i] * scale;
          if (edge) {
            const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
            x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
          }
          s[i] = expf(x - stat[(i % 4) / 2]);
        }
        // once warpgroup 1 has read the previous tile's dS
        if (kt > 0) named_sync(3, kSlConsumers);
        tf_put(xb, xb + 2 * kTfBox, s);
        named_arrive(1, kSlConsumers);
        named_sync(2, kSlConsumers);
      } else {
        // dS = P∘(dP - delta)·scale, P from warpgroup 0 (its parts)
        named_sync(1, kSlConsumers);
        float p[32];
        tf_get(p, xb, xb + 2 * kTfBox);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = p[i] * (s[i] - stat[(i % 4) / 2]) * scale;
        tf_put(xb, xb + 2 * kTfBox, s);
        fence_proxy_async();
        named_arrive(2, kSlConsumers);
        named_sync(4, 128);
      }
#pragma unroll
      for (int p = 0; p < OWN; ++p) {
        const uint32_t tile = ring.wait() + 2 * G * kTfBox;
        if (p < mine)
          tf_out_step(acc[p], tile, xb, xb + 2 * kTfBox, 32 * halves);
        ring.release();
      }
      if (G == 1 && kt + 1 < nkt) named_arrive(3, kSlConsumers);  // dS read
    }
    tf_store<OWN>(dq, acc, mine, b, h, q0, col0 + 64 * OWN * G, Sq, H, D);
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

// dq at head dims up to 128: CTA = 128 query rows of one (b, h), the
// heaviest first (grid (B·H, ceil(Sq / 128))), each consumer warpgroup
// its own 64 (no P/dS hand-off): per key tile it forms S = Q·Kᵀ over nc
// = D/32 score steps, P in registers, dP = dO·Vᵀ over nc more, dS = P∘(dP
// - delta)·scale in registers, puts dS's parts in a tile of its own
// (named barrier 1 + g over its 128 threads, taken before the writes too,
// as the 128-row forward takes it: the previous tile's output steps read
// that tile as B, and a warp's wgmma wait covers its own products only)
// and adds Kᵀ·dSᵀ to each of its NC = chunks(D) 64-column chunks of dqᵀ.
// A stage of the ring holds
// both warpgroups' A boxes (Q, or dO, raw) and the walked tile's B parts
// (K's, or V's): four [64][32] boxes; an output step a chunk of K's
// columns (its first half at D 32). K's and V's parts come once a 128
// rows; under the causal mask a warpgroup passes the key tiles past its
// last row without products.
constexpr int kRowsStage = 4 * kTfBox;
// the 128-row forward's α and 1 / l of both warpgroups' rows: f32 [64]
// each, 512 bytes a warpgroup
constexpr int kRowsStats = 2 * 2 * 64 * 4;
template <int NC>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_dq_rows_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                          const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap dom,
                          const __grid_constant__ CUtensorMap khm,
                          const __grid_constant__ CUtensorMap klm,
                          const __grid_constant__ CUtensorMap vhm,
                          const __grid_constant__ CUtensorMap vlm,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int H, int Sq, int Skv,
                          int D, int ns, float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 32, halves = D % 64 ? 1 : 2;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kRowsStage;    // dS parts, a tile each
  TfRing ring{base, xb + 8 * kTfBox, ns};
  auto at = [&] { return base + ring.st * kRowsStage; };   // the stage
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int q0 = 128 * (gridDim.y - 1 - blockIdx.y);    // heaviest first
  const int nk = (Skv + kSlKeys - 1) / kSlKeys;
  const int nkt =
      causal ? min(nk, (min(q0 + 128, Sq) - 1) / kSlKeys + 1) : nk;
  tf_init(ring.bars, ns);

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kSlConsumers) {
      int t = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * kSlKeys;
        for (int j = 0; j < 2 * nc; ++j, ++t, ring.next()) {
          const bool dp = j >= nc;         // S's steps, then dP's
          const int c = 32 * (j % nc);
          ring.acquire(t, kRowsStage);
          const uint32_t dst = at();
          tma_load(dst, dp ? &dom : &qm, ring.full(), c, h, q0, b);
          tma_load(dst + kTfBox, dp ? &dom : &qm, ring.full(), c, h, q0 + 64,
                   b);
          tma_load(dst + 2 * kTfBox, dp ? &vhm : &khm, ring.full(), c, h, k0,
                   b);
          tma_load(dst + 3 * kTfBox, dp ? &vlm : &klm, ring.full(), c, h, k0,
                   b);
        }
        for (int p = 0; p < NC; ++p, ++t, ring.next()) {
          ring.acquire(t, halves * kTfBox);
          for (int e = 0; e < halves; ++e)
            tma_load(at() + e * kTfBox, &km, ring.full(), 64 * p + 32 * e, h,
                     k0, b);
        }
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  const int l = tid % 32;
  auto consume = [&](auto role) {
    constexpr int G = decltype(role)::kDk ? 1 : 0;
    const int qg = q0 + 64 * G;            // this warpgroup's rows
    const int row0 = qg + 16 * ((tid / 32) % 4) + l / 4;
    const uint32_t mine = xb + 4 * G * kTfBox;   // its dS parts
    const int nmine =
        causal ? min(nkt, (min(qg + 64, Sq) - 1) / kSlKeys + 1) : nkt;
    float rl[2], rd[2];                    // lse and delta of its rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s_ = row0 + 8 * r;
      const int64_t i = (static_cast<int64_t>(b) * Sq + s_) * H + h;
      rl[r] = s_ < Sq ? lse[i] : 0.f;
      rd[r] = s_ < Sq ? delta[i] : 0.f;
    }
    float acc[NC][32], s[32], p[32];
#pragma unroll
    for (int j = 0; j < NC; ++j) zero(acc[j]);
    zero(s);
    for (int kt = 0; kt < nkt; ++kt) {
      const bool live = kt < nmine;
      for (int c = 0; c < nc; ++c) {       // S = Q·Kᵀ
        ring.wait();
        const uint32_t st = at();
        if (live)
          tf_score_step(s, st + G * kTfBox, st + 2 * kTfBox, st + 3 * kTfBox,
                        c == 0);
        ring.release();
      }
      // P from the scaled, masked scores
      const int k0 = kt * kSlKeys;
      const bool edge =
          (causal && k0 + kSlKeys - 1 > qg) || k0 + kSlKeys > Skv;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale;
        if (edge) {
          const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
          x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
        }
        p[i] = expf(x - rl[(i % 4) / 2]);
      }
      for (int c = 0; c < nc; ++c) {       // dP = dO·Vᵀ
        ring.wait();
        const uint32_t st = at();
        if (live)
          tf_score_step(s, st + G * kTfBox, st + 2 * kTfBox, st + 3 * kTfBox,
                        c == 0);
        ring.release();
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = p[i] * (s[i] - rd[(i % 4) / 2]) * scale;
        // the last tile's output steps read this tile as B: a warp's
        // wgmma wait covers its own products only, so every warp of the
        // warpgroup must be past its reads before any warp writes
        named_sync(1 + G, 128);
        tf_put(mine, mine + 2 * kTfBox, s);
        fence_proxy_async();
        named_sync(1 + G, 128);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {       // dqᵀ += Kᵀ·dSᵀ
        ring.wait();
        if (live)
          tf_out_step(acc[j], at(), mine, mine + 2 * kTfBox, 32 * halves);
        ring.release();
      }
    }
    tf_store<NC>(dq, acc, NC, b, h, qg, 0, Sq, H, D);
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

// The forward at head dims up to 128: dq_rows's walk without dP and dS,
// and the online softmax inside each warpgroup. CTA = 128 query rows of
// one (b, h), the heaviest first (grid (B·H, ceil(Sq / 128))), each
// consumer warpgroup its own 64: per key tile it forms S = Q·Kᵀ over nc
// = D/32 score steps (a stage: both warpgroups' raw Q boxes and K's high
// and low boxes), scales and masks S, updates its rows' max m and sum l
// in registers, puts P's parts and each row's rescale factor α =
// exp(m_old - m_new) in tiles of its own (named barrier 1 + g over its
// 128 threads), multiplies its NC = chunks(D) chunks of oᵀ, whose
// columns are the queries, by α and adds Vᵀ·Pᵀ over NC output steps (a
// stage: a 64-column chunk of V, raw; its first half at D 32). At the
// end 1 / l goes through its tile too, and lse = m + log l. The barrier
// is also taken before P and α are written: a warp's wgmma wait covers
// its own rows only, so the warpgroup's other warps may still be reading
// the last tile's. Under the causal mask a warpgroup passes the key
// tiles past its last row without products.
template <int NC>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_fwd_rows_tf32_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap vm,
                           const __grid_constant__ CUtensorMap khm,
                           const __grid_constant__ CUtensorMap klm,
                           float* __restrict__ o, float* __restrict__ lse,
                           int H, int Sq, int Skv, int D, int ns,
                           float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 32, halves = D % 64 ? 1 : 2;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kRowsStage;    // P's parts, a tile each
  const uint32_t stats = xb + 8 * kTfBox;  // α and 1 / l, f32 [64] each
  TfRing ring{base, stats + kRowsStats, ns};
  auto at = [&] { return base + ring.st * kRowsStage; };   // the stage
  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int q0 = 128 * (gridDim.y - 1 - blockIdx.y);    // heaviest first
  const int nk = (Skv + kSlKeys - 1) / kSlKeys;
  const int nkt =
      causal ? min(nk, (min(q0 + 128, Sq) - 1) / kSlKeys + 1) : nk;
  tf_init(ring.bars, ns);

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kSlConsumers) {
      int t = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * kSlKeys;
        for (int c = 0; c < nc; ++c, ++t, ring.next()) {
          ring.acquire(t, kRowsStage);
          const uint32_t dst = at();
          tma_load(dst, &qm, ring.full(), 32 * c, h, q0, b);
          tma_load(dst + kTfBox, &qm, ring.full(), 32 * c, h, q0 + 64, b);
          tma_load(dst + 2 * kTfBox, &khm, ring.full(), 32 * c, h, k0, b);
          tma_load(dst + 3 * kTfBox, &klm, ring.full(), 32 * c, h, k0, b);
        }
        for (int p = 0; p < NC; ++p, ++t, ring.next()) {
          ring.acquire(t, halves * kTfBox);
          for (int e = 0; e < halves; ++e)
            tma_load(at() + e * kTfBox, &vm, ring.full(), 64 * p + 32 * e, h,
                     k0, b);
        }
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  const int l = tid % 32;
  auto consume = [&](auto role) {
    constexpr int G = decltype(role)::kDk ? 1 : 0;
    const int qg = q0 + 64 * G;            // this warpgroup's rows
    const int row0 = qg + 16 * ((tid / 32) % 4) + l / 4;
    const uint32_t mine = xb + 4 * G * kTfBox;   // its P parts
    const uint32_t rs = stats + G * kRowsStats / 2;   // its α, 1 / l
    const int nmine =
        causal ? min(nkt, (min(qg + 64, Sq) - 1) / kSlKeys + 1) : nkt;
    float acc[NC][32], s[32];
    float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC; ++j) zero(acc[j]);
    zero(s);
    for (int kt = 0; kt < nkt; ++kt) {
      const bool live = kt < nmine;
      for (int c = 0; c < nc; ++c) {       // S = Q·Kᵀ
        ring.wait();
        const uint32_t st = at();
        if (live)
          tf_score_step(s, st + G * kTfBox, st + 2 * kTfBox, st + 3 * kTfBox,
                        c == 0);
        ring.release();
      }
      if (live) {
        // scale, mask where the tile crosses the diagonal or the end
        const int k0 = kt * kSlKeys;
        const bool edge =
            (causal && k0 + kSlKeys - 1 > qg) || k0 + kSlKeys > Skv;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = s[i] * scale;
          if (edge) {
            const int kpos = k0 + acc_col(i, l), qpos = row0 + acc_row(i);
            x = kpos >= Skv ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
          }
          s[i] = x;
          mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = expf(m[r] - m_new);
          m[r] = m_new;
          lsum[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = expf(s[i] - m[(i % 4) / 2]);
          lsum[(i % 4) / 2] += s[i];       // this thread's part of the row
        }
        named_sync(1 + G, 128);            // the last tile's P, α read
        tf_put(mine, mine + 2 * kTfBox, s);
        if (l % 4 == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_shared(rs + 4 * (row0 - qg + 8 * r), alpha[r]);
        }
        fence_proxy_async();
        named_sync(1 + G, 128);
        tf_scale_cols<NC>(acc, rs);        // oᵀ at the new running max
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {       // oᵀ += Vᵀ·Pᵀ
        ring.wait();
        if (live)
          tf_out_step(acc[j], at(), mine, mine + 2 * kTfBox, 32 * halves);
        ring.release();
      }
    }
    // 1 / l of each row beside α, and lse
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s_ = row0 + 8 * r;
      lsum[r] = quad_sum(lsum[r]);
      if (l % 4 == 0) {
        st_shared(rs + 4 * (64 + s_ - qg), 1.f / lsum[r]);
        if (s_ < Sq)
          lse[(static_cast<int64_t>(b) * Sq + s_) * H + h] =
              m[r] + logf(lsum[r]);
      }
    }
    named_sync(1 + G, 128);
    tf_scale_cols<NC>(acc, rs + 4 * 64);
    tf_store<NC>(o, acc, NC, b, h, qg, 0, Sq, H, D);
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

// dk and dv: CTA = 64 keys of one (b, h), the heaviest (lowest) tiles
// first, and a slice of OWN 64-column chunks of dk and dv (grid
// (B·H·slices, ceil(Skv / 64)), the slice innermost). A score step holds
// the K, Q, V and dO boxes of (query tile, 32 columns); output step p the
// query tile's dO and Q columns of chunk p. Warpgroup 0 forms Pᵀ and puts
// its parts in tiles warpgroup 1 reads (named barrier 1; barrier 2 says
// they were read), then adds dOᵀ·P to dvᵀ; warpgroup 1 forms dSᵀ =
// Pᵀ∘(dPᵀ - delta)·scale, puts it in tiles of its own and adds Qᵀ·dS to
// dkᵀ. The query tile's lse and delta are staged by a producer warp. At
// head dim 32 output steps load and use a chunk's first 32 columns
// (`halves`), as dq's.
template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
flash_dkdv_sliced_tf32_kernel(const __grid_constant__ CUtensorMap qm,
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
                              int H, int Sq, int Skv, int D, int nsl, int ns,
                              float scale, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 32, halves = D % 64 ? 1 : 2;  // 32-column tiles a chunk
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kTfStage;      // Pᵀ, then dSᵀ, parts
  const uint32_t stats = xb + 8 * kTfBox;  // lse, then delta: f32 [64]
  TfRing ring{base, base + tf_bars_at(ns, 2), ns};
  const uint32_t sfull = ring.bars + 16 * kTfMaxStages, sempty = sfull + 8;

  const int z = blockIdx.x % nsl, bh = blockIdx.x / nsl;
  const int b = bh / H, h = bh % H, tid = threadIdx.x;
  const int col0 = 64 * OWN * z, k0 = kSlKeys * blockIdx.y;
  const int nq = (Sq + 63) / 64;
  // causal: query tiles wholly before the key tile see none of its keys
  const int qt0 = causal ? min(static_cast<int>(blockIdx.y), nq) : 0;
  tf_init(ring.bars, ns);

  if (tid >= kSlConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kSlConsumers) {
      int t = 0;
      for (int qt = qt0; qt < nq; ++qt) {
        const int q0 = 64 * qt;
        for (int c = 0; c < nc; ++c, ++t, ring.next())
          tf_load_score(ring.acquire(t, kTfStage), ring.full(), c, h, k0,
                        q0, b, &km, &qhm, &qlm, &vm, &dohm, &dolm);
        for (int p = 0; p < OWN; ++p, ++t, ring.next()) {
          const uint32_t dst = ring.acquire(t, 2 * halves * kTfBox);
          for (int e = 0; e < halves; ++e) {
            tma_load(dst + e * kTfBox, &dom, ring.full(),
                     col0 + 64 * p + 32 * e, h, q0, b);
            tma_load(dst + (2 + e) * kTfBox, &qm, ring.full(),
                     col0 + 64 * p + 32 * e, h, q0, b);
          }
        }
      }
    } else if (tid / 32 == kSlConsumers / 32 + 1) {
      // each query tile's lse and delta (0 past Sq), once the previous
      // tile's were read: the warp's stores, then lane 0's arrival (a
      // release) on sfull
      const int ln = tid % 32;
      const float* const lse_bh = lse + static_cast<int64_t>(b) * Sq * H + h;
      const float* const delta_bh =
          delta + static_cast<int64_t>(b) * Sq * H + h;
      for (int qt = qt0; qt < nq; ++qt) {
        if (qt > qt0) bar_wait(sempty, (qt - qt0 - 1) & 1);
        for (int i = 64 * qt + ln; i < 64 * qt + 64; i += 32) {
          const uint32_t at = stats + 4 * (i - 64 * qt);
          st_shared(at, i < Sq ? lse_bh[static_cast<int64_t>(i) * H] : 0.f);
          st_shared(at + 4 * 64,
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
    constexpr bool DK = decltype(role)::kDk;
    constexpr int G = DK ? 1 : 0;
    const uint32_t out = xb + 4 * G * kTfBox;   // Pᵀ (0) or dSᵀ (1) parts
    float acc[OWN][32], s[32];             // s: Sᵀ (dv) or dPᵀ (dk)
#pragma unroll
    for (int j = 0; j < OWN; ++j) zero(acc[j]);
    zero(s);
    int sph = 0;
    for (int q0 = 64 * qt0; q0 < Sq; q0 += 64) {
      for (int c = 0; c < nc; ++c) {
        const uint32_t st = ring.wait();
        tf_score_step(s, st + 2 * G * kTfBox, st + (2 * G + 1) * kTfBox,
                      st + (4 + G) * kTfBox, c == 0);
        ring.release();
      }
      warp_wait(sfull, sph);               // the tile's lse and delta
      sph ^= 1;
      if constexpr (!DK) {
        // Pᵀ from the scaled, masked scores: rows keys, columns queries
        const bool edge = (causal && k0 + kSlKeys - 1 > q0) || q0 + 64 > Sq;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = q0 + acc_col(i, l);
          const int kpos = k0 + krow + acc_row(i);
          float x = s[i] * scale;
          if (edge)
            x = qpos >= Sq ? -INFINITY : (causal && kpos > qpos) ? kMask : x;
          s[i] = expf(x - ld_shared(stats + 4 * acc_col(i, l)));
        }
        // put Pᵀ once warpgroup 1 has read the previous tile's
        if (q0 > 64 * qt0) named_sync(2, kSlConsumers);
        tf_put(out, out + 2 * kTfBox, s);
        fence_proxy_async();
        named_arrive(1, kSlConsumers);
        named_sync(3, 128);
      } else {
        // dSᵀ = Pᵀ∘(dPᵀ - delta)·scale, Pᵀ from warpgroup 0 (its parts)
        named_sync(1, kSlConsumers);
        float p[32];
        tf_get(p, xb, xb + 2 * kTfBox);
        if (q0 + 64 < Sq) named_arrive(2, kSlConsumers);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = p[i] *
                 (s[i] - ld_shared(stats + 4 * (64 + acc_col(i, l)))) *
                 scale;
        tf_put(out, out + 2 * kTfBox, s);
        fence_proxy_async();
        named_sync(4, 128);
      }
      __syncwarp();
      if (l == 0) bar_arrive(sempty);      // lse and delta read
#pragma unroll
      for (int p = 0; p < OWN; ++p) {      // dOᵀ·P, or Qᵀ·dS
        const uint32_t tile = ring.wait() + 2 * G * kTfBox;
        tf_out_step(acc[p], tile, out, out + 2 * kTfBox, 32 * halves);
        ring.release();
      }
    }
    tf_store<OWN>(DK ? dk : dv, acc, OWN, b, h, k0, col0, Skv, H, D);
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Role<false>{});
  else
    consume(Role<true>{});
}

// --- host: tensor maps and launchers ---

// (B, S, H, D) bf16 at ptr as a (D, H, S, B) map with boxes (64, 1, rows,
// 1), 128-byte swizzle; reads past S (and past D, at D 32) fill zeros.
// f32: boxes of (32, 1, rows, 1), the same 128-byte rows.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             int rows, bool f32 = false) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * (f32 ? 4 : 2);
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {f32 ? 32u : 64u, 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map,
                         f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapFailed + static_cast<int>(r);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Sq, int Skv, float scale, int causal,
        cudaStream_t st) {
  constexpr int kN = fwd_keys(D);
  CUtensorMap qm, km, vm;
  if (int e = make_map(&qm, q, B, Sq, H, D, kRows)) return e;
  if (int e = make_map(&km, k, B, Skv, H, D, kN)) return e;
  if (int e = make_map(&vm, v, B, Skv, H, D, kN)) return e;
  constexpr int kTileRow = chunks(D) * kRowBytes;
  constexpr size_t smem =
      Layout<kRows * kTileRow, 2 * kN * kTileRow>::kSmem;
  auto kernel = flash_fwd_tc_kernel<D>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(qm, km, vm, static_cast<bf16*>(o),
                                       lse, H, Sq, Skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dq_out, int B, int H,
       int Sq, int Skv, float scale, int causal, cudaStream_t st) {
  constexpr int kM = 64 * dq_warpgroups(D);           // query rows a CTA
  CUtensorMap qm, km, vm, dom;
  if (int e = make_map(&qm, q, B, Sq, H, D, kM)) return e;
  if (int e = make_map(&dom, dout, B, Sq, H, D, kM)) return e;
  if (int e = make_map(&km, k, B, Skv, H, D, 64)) return e;
  if (int e = make_map(&vm, v, B, Skv, H, D, 64)) return e;
  constexpr int kTileRow = chunks(D) * kRowBytes;
  constexpr size_t smem =
      Layout<2 * kM * kTileRow, 2 * 64 * kTileRow>::kSmem;
  auto kernel = flash_dq_tc_kernel<D>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Sq + kM - 1) / kM);
  kernel<<<grid, 2 * kM, smem, st>>>(qm, km, vm, dom, lse, delta,
                                       static_cast<bf16*>(dq_out), H, Sq,
                                       Skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the dk/dv kernel of head dim D (only that one is instantiated)
template <int D>
constexpr auto dkdv_kernel() {
  if constexpr (D > 128)
    return flash_dkdv_split_tc_kernel<D>;
  else
    return flash_dkdv_tc_kernel<D>;
}

template <int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, void* dk, void* dv, int B,
         int H, int Sq, int Skv, float scale, int causal, cudaStream_t st) {
  // keys a CTA: 128 (64 a warpgroup), or 64 past D 128 (the split kernel)
  constexpr int kN = D > 128 ? 64 : kRows;
  CUtensorMap qm, km, vm, dom;
  if (int e = make_map(&km, k, B, Skv, H, D, kN)) return e;
  if (int e = make_map(&vm, v, B, Skv, H, D, kN)) return e;
  if (int e = make_map(&qm, q, B, Sq, H, D, 64)) return e;
  if (int e = make_map(&dom, dout, B, Sq, H, D, 64)) return e;
  constexpr int kTileRow = chunks(D) * kRowBytes;
  constexpr size_t smem =
      Layout<2 * kN * kTileRow, 2 * 64 * kTileRow>::kSmem;
  auto kernel = dkdv_kernel<D>();
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Skv + kN - 1) / kN);
  kernel<<<grid, kThreads, smem, st>>>(qm, km, vm, dom, lse, delta,
                                       static_cast<bf16*>(dk),
                                       static_cast<bf16*>(dv), H, Sq, Skv,
                                       scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// output chunks a slice of the forward past D 256 owns: the fewest
// slices of at most kSlMaxChunks, as even as they come (3 or 4 for every
// nc >= 5); the last slice's chunks past D are TMA's zeros, not stored
inline int sl_own(int nc) {
  const int fewest = (nc + kSlMaxChunks - 1) / kSlMaxChunks;
  return (nc + fewest - 1) / fewest;
}

// the card's SMs: query tiles are paired where the grid fits them once
inline int sm_count(int* sms) {
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

template <int OWN>
int fwd_sliced_own(int D, const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* o, float* lse, int B, int H,
                   int Sq, int Skv, float scale, int causal,
                   cudaStream_t st) {
  const int nc = D / 64, nsl = (nc + OWN - 1) / OWN;
  // Q stays in shared memory for the whole walk where it fits beside the
  // V slice and a ring of kSlMinStages (D <= 576), else comes a chunk a
  // step; the ring takes the rest, up to kSlMaxStages
  const bool q_res = sl_smem(nc, OWN, true, kSlMinStages) <= kSmemMax;
  const int ns = min(kSlMaxStages,
                     static_cast<int>((kSmemMax - sl_smem(nc, OWN, q_res, 0)) /
                                      sl_stage_bytes(q_res)));
  const size_t smem = sl_smem(nc, OWN, q_res, ns);
  auto kernel = flash_fwd_sliced_tc_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H * nsl, (Sq + 127) / 128);
  // causal tiles paired where the grid fills the card at most once; past
  // that the heaviest-first order balances whole CTAs across the waves
  // better (scripts/flash_sliced_knockout.py)
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  const int paired = causal && grid.x * grid.y <= static_cast<unsigned>(sms);
  kernel<<<grid, kSlThreads, smem, st>>>(qm, km, vm, static_cast<bf16*>(o),
                                         lse, H, Sq, Skv, D, nsl, q_res, ns,
                                         paired, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int fwd_sliced(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Sq, int Skv, float scale,
               int causal, cudaStream_t st) {
  CUtensorMap qm, km, vm;
  if (int e = make_map(&qm, q, B, Sq, H, D, 64)) return e;
  if (int e = make_map(&km, k, B, Skv, H, D, kSlKeys)) return e;
  if (int e = make_map(&vm, v, B, Skv, H, D, kSlKeys)) return e;
  if (sl_own(D / 64) == 3)
    return fwd_sliced_own<3>(D, qm, km, vm, o, lse, B, H, Sq, Skv, scale,
                             causal, st);
  return fwd_sliced_own<4>(D, qm, km, vm, o, lse, B, H, Sq, Skv, scale,
                           causal, st);
}

// dq keeps Q resident where it fits beside a ring of kDqMinStages, the
// ring taking the rest up to kSlMaxStages (a 2-stage ring beside it is
// slower than streaming Q: scripts/flash_sliced_knockout.py)
constexpr int kDqMinStages = 3;

template <int OWN>
int dq_sliced_own(int D, const CUtensorMap& qm, const CUtensorMap& km,
                  const CUtensorMap& vm, const CUtensorMap& dom,
                  const float* lse, const float* delta, void* dq_out, int B,
                  int H, int Sq, int Skv, float scale, int causal,
                  cudaStream_t st) {
  const int nc = D / 64, nsl = (nc + OWN - 1) / OWN;
  // Q resident where it fits beside the K slice and a ring of
  // kDqMinStages (D 320 and 384), else a chunk pair a step through the
  // ring with K, V and dO
  const bool q_res = dq_smem(nc, OWN, true, kDqMinStages) <= kSmemMax;
  const int ns = min(kSlMaxStages,
                     static_cast<int>((kSmemMax - dq_smem(nc, OWN, q_res, 0)) /
                                      dq_stage_bytes(q_res)));
  const size_t smem = dq_smem(nc, OWN, q_res, ns);
  auto kernel = flash_dq_sliced_tc_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H * nsl, (Sq + 127) / 128);
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  // query tiles paired as in the forward: only within one wave
  const int dq_paired =
      causal && grid.x * grid.y <= static_cast<unsigned>(sms);
  kernel<<<grid, kSlThreads, smem, st>>>(
      qm, km, vm, dom, lse, delta, static_cast<bf16*>(dq_out), H, Sq, Skv, D,
      nsl, q_res, ns, dq_paired, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int OWN>
int dkdv_sliced_own(int D, const CUtensorMap& qm, const CUtensorMap& km,
                    const CUtensorMap& vm, const CUtensorMap& dom,
                    const float* lse, const float* delta, void* dk, void* dv,
                    int B, int H, int Sq, int Skv, float scale, int causal,
                    cudaStream_t st) {
  const int nc = D / 64, nsl = (nc + OWN - 1) / OWN;
  // every operand streamed a chunk a step: the ring takes what the
  // slices leave, up to kSlMaxStages (5 at OWN 4)
  const int ns = min(kSlMaxStages,
                     static_cast<int>((kSmemMax - dkdv_smem(OWN, 0)) /
                                      kDkdvStageBytes));
  const size_t smem = dkdv_smem(OWN, ns);
  auto kernel = flash_dkdv_sliced_tc_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H * nsl, (Skv + kSlKeys - 1) / kSlKeys);
  kernel<<<grid, kSlThreads, smem, st>>>(
      qm, km, vm, dom, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Skv, D, nsl, ns, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the maps of the backward past D 256: boxes of 64 rows of every operand
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
             const void* v, const void* dout, int B, int H, int Sq, int Skv,
             int D) {
  if (int e = make_map(&m[0], q, B, Sq, H, D, 64)) return e;
  if (int e = make_map(&m[1], k, B, Skv, H, D, kSlKeys)) return e;
  if (int e = make_map(&m[2], v, B, Skv, H, D, kSlKeys)) return e;
  return make_map(&m[3], dout, B, Sq, H, D, 64);
}

int dq_sliced(int D, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq_out, int B, int H, int Sq, int Skv, float scale,
              int causal, cudaStream_t st) {
  CUtensorMap m[4];
  if (int e = bwd_maps(m, q, k, v, dout, B, H, Sq, Skv, D)) return e;
  // slices as the forward's (sl_own): 4 chunks at D 512
  return sl_own(D / 64) == 3
             ? dq_sliced_own<3>(D, m[0], m[1], m[2], m[3], lse, delta,
                                dq_out, B, H, Sq, Skv, scale, causal, st)
             : dq_sliced_own<4>(D, m[0], m[1], m[2], m[3], lse, delta,
                                dq_out, B, H, Sq, Skv, scale, causal, st);
}

int dkdv_sliced(int D, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int H, int Sq, int Skv,
                float scale, int causal, cudaStream_t st) {
  CUtensorMap m[4];
  if (int e = bwd_maps(m, q, k, v, dout, B, H, Sq, Skv, D)) return e;
  return sl_own(D / 64) == 3
             ? dkdv_sliced_own<3>(D, m[0], m[1], m[2], m[3], lse, delta, dk,
                                  dv, B, H, Sq, Skv, scale, causal, st)
             : dkdv_sliced_own<4>(D, m[0], m[1], m[2], m[3], lse, delta, dk,
                                  dv, B, H, Sq, Skv, scale, causal, st);
}

// the parts of two (B, S, H, D) f32 tensors x0, x1 into `work` (hi0, lo0,
// hi1, lo1, n = B·S·H·D floats each), and their four maps; of x0 alone
// (hi0, lo0 and their two maps) where x1 is null
int tf_split(CUtensorMap (&m)[4], const void* x0, const void* x1,
             float* work, int B, int S, int H, int D, cudaStream_t st) {
  const int64_t n = static_cast<int64_t>(B) * S * H * D;
  const int tensors = x1 ? 2 : 1;
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  for (int j = 0; j < tensors; ++j)
    if (int e = tf_split_pass(j ? x1 : x0, work + 2 * j * n,
                              work + (2 * j + 1) * n, n, sms, st))
      return e;
  for (int j = 0; j < 2 * tensors; ++j)
    if (int e = make_map(&m[j], work + j * n, B, S, H, D, 64, true)) return e;
  return 0;
}

// the ring takes what the P/dS tiles and the stats leave, up to
// kSlMaxStages: dq 4 stages, dk/dv and the forward 3
inline int tf_stages(int outs) {
  return min(kSlMaxStages,
             static_cast<int>((kSmemMax - tf_smem(0, outs)) / kTfStage));
}

// chunks of a slice of the kernels whose CTAs hold 64 query rows (dq and
// the forward; `rows` CTAs a slice): the fewest slices of at most 2 x
// kTfMaxOwn chunks (dq's D 192-512 one slice, 576-1024 two), or of 2 x 3
// where that grid fits one wave of the SMs (more, lighter CTAs even out
// the causal rows' work: D 512 two), as even as they come; warpgroup 0
// takes OWN = ceil(own / 2) of them and warpgroup 1 the rest
int tf_row_slices(int D, int rows, int* own) {
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  const int nc = chunks(D);
  int most = 2 * kTfMaxOwn, fewest = (nc + most - 1) / most;
  if (rows * fewest <= sms) {
    most = 6;
    fewest = (nc + most - 1) / most;
  }
  *own = (nc + fewest - 1) / fewest;
  return 0;
}

template <int OWN>
int fwd_sliced_tf32_own(int D, int own, const CUtensorMap (&m)[2],
                        const CUtensorMap (&kp)[4], void* o, float* lse,
                        int B, int H, int Sq, int Skv, float scale,
                        int causal, cudaStream_t st) {
  // P's parts and warpgroup 1's half of S take the space of two P/dS
  // tile sets (16 KB of it unused: the ring has 3 stages either way)
  const int ns = tf_stages(2), nsl = (D / 64 + own - 1) / own;
  const size_t smem = tf_smem(ns, 2);
  auto kernel = flash_fwd_sliced_tf32_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H * nsl, (Sq + 63) / 64);
  kernel<<<grid, kSlThreads, smem, st>>>(
      m[0], m[1], kp[0], kp[1], static_cast<float*>(o), lse, H, Sq, Skv, D,
      nsl, own, ns, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the 128-row forward up to D 128: a ring of 32 KB stages beside the two
// P part tiles and the rows' α and 1 / l (5 stages)
template <int NC>
int fwd_rows_tf32(int D, const CUtensorMap (&m)[2], const CUtensorMap (&kp)[4],
                  void* o, float* lse, int B, int H, int Sq, int Skv,
                  float scale, int causal, cudaStream_t st) {
  constexpr int kFixed =
      1024 + 8 * kTfBox + kRowsStats + 8 * (2 * kTfMaxStages + 2);
  const int ns =
      min(kTfMaxStages, static_cast<int>((kSmemMax - kFixed) / kRowsStage));
  const size_t smem = kFixed + ns * kRowsStage;
  auto kernel = flash_fwd_rows_tf32_kernel<NC>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Sq + 127) / 128);
  kernel<<<grid, kSlThreads, smem, st>>>(
      m[0], m[1], kp[0], kp[1], static_cast<float*>(o), lse, H, Sq, Skv, D,
      ns, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// the forward: K split into `work` (2·B·Skv·H·D floats), then the kernel:
// up to D 128 the 128-row one, past it the 64-row one whose warpgroups
// each sum half of S (one slice of all of D at 192 and 256)
int fwd_sliced_tf32(int D, const void* q, const void* k, const void* v,
                    void* o, float* lse, int B, int H, int Sq, int Skv,
                    float scale, int causal, cudaStream_t st, float* work) {
  if (!work) return -1;
  CUtensorMap m[2], kp[4];                 // q, v raw; K's parts (two)
  if (int e = make_map(&m[0], q, B, Sq, H, D, 64, true)) return e;
  if (int e = make_map(&m[1], v, B, Skv, H, D, kSlKeys, true)) return e;
  if (int e = tf_split(kp, k, nullptr, work, B, Skv, H, D, st)) return e;
  if (D <= 64)
    return fwd_rows_tf32<1>(D, m, kp, o, lse, B, H, Sq, Skv, scale, causal,
                            st);
  if (D <= 128)
    return fwd_rows_tf32<2>(D, m, kp, o, lse, B, H, Sq, Skv, scale, causal,
                            st);
  int own = 0;
  if (int e = tf_row_slices(D, B * H * ((Sq + 63) / 64), &own)) return e;
  switch ((own + 1) / 2) {
    case 2:
      return fwd_sliced_tf32_own<2>(D, own, m, kp, o, lse, B, H, Sq, Skv,
                                    scale, causal, st);
    case 3:
      return fwd_sliced_tf32_own<3>(D, own, m, kp, o, lse, B, H, Sq, Skv,
                                    scale, causal, st);
    default:
      return fwd_sliced_tf32_own<4>(D, own, m, kp, o, lse, B, H, Sq, Skv,
                                    scale, causal, st);
  }
}

template <int OWN>
int dq_sliced_tf32_own(int D, int own, const CUtensorMap (&m)[3],
                       const CUtensorMap (&p)[4], const float* lse,
                       const float* delta, void* dq_out, int B, int H,
                       int Sq, int Skv, float scale, int causal,
                       cudaStream_t st) {
  const int ns = tf_stages(1), nsl = (chunks(D) + own - 1) / own;
  const size_t smem = tf_smem(ns, 1);
  auto kernel = flash_dq_sliced_tf32_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H * nsl, (Sq + 63) / 64);
  kernel<<<grid, kSlThreads, smem, st>>>(
      m[0], m[1], m[2], p[0], p[1], p[2], p[3], lse, delta,
      static_cast<float*>(dq_out), H, Sq, Skv, D, nsl, own, ns, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// the 128-row dq up to D 128: a ring of 32 KB stages beside the two dS
// part tiles (5 stages)
template <int NC>
int dq_rows_tf32(int D, const CUtensorMap (&m)[3], const CUtensorMap (&p)[4],
                 const float* lse, const float* delta, void* dq_out, int B,
                 int H, int Sq, int Skv, float scale, int causal,
                 cudaStream_t st) {
  constexpr int kFixed = 1024 + 8 * kTfBox + 8 * (2 * kTfMaxStages + 2);
  const int ns =
      min(kTfMaxStages, static_cast<int>((kSmemMax - kFixed) / kRowsStage));
  const size_t smem = kFixed + ns * kRowsStage;
  auto kernel = flash_dq_rows_tf32_kernel<NC>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Sq + 127) / 128);
  kernel<<<grid, kSlThreads, smem, st>>>(
      m[0], m[1], m[2], p[0], p[1], p[2], p[3], lse, delta,
      static_cast<float*>(dq_out), H, Sq, Skv, D, ns, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dq: K and V split into `work` (4·B·Skv·H·D floats), then the kernel: up
// to D 128 the 128-row one, past it the 64-row one with the P/dS hand-off
int dq_sliced_tf32(int D, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq_out, int B, int H, int Sq, int Skv, float scale,
                   int causal, cudaStream_t st, float* work) {
  if (!work) return -1;
  CUtensorMap m[3], p[4];                  // q, k, dO raw; K, V parts
  if (int e = make_map(&m[0], q, B, Sq, H, D, 64, true)) return e;
  if (int e = make_map(&m[1], k, B, Skv, H, D, kSlKeys, true)) return e;
  if (int e = make_map(&m[2], dout, B, Sq, H, D, 64, true)) return e;
  if (int e = tf_split(p, k, v, work, B, Skv, H, D, st)) return e;
  if (D <= 64)
    return dq_rows_tf32<1>(D, m, p, lse, delta, dq_out, B, H, Sq, Skv, scale,
                           causal, st);
  if (D <= 128)
    return dq_rows_tf32<2>(D, m, p, lse, delta, dq_out, B, H, Sq, Skv, scale,
                           causal, st);
  int own = 0;
  if (int e = tf_row_slices(D, B * H * ((Sq + 63) / 64), &own)) return e;
  switch ((own + 1) / 2) {
    case 2:
      return dq_sliced_tf32_own<2>(D, own, m, p, lse, delta, dq_out, B, H,
                                   Sq, Skv, scale, causal, st);
    case 3:
      return dq_sliced_tf32_own<3>(D, own, m, p, lse, delta, dq_out, B, H,
                                   Sq, Skv, scale, causal, st);
    default:
      return dq_sliced_tf32_own<4>(D, own, m, p, lse, delta, dq_out, B, H,
                                   Sq, Skv, scale, causal, st);
  }
}

template <int OWN>
int dkdv_sliced_tf32_own(int D, const CUtensorMap (&m)[4],
                         const CUtensorMap (&p)[4], const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int H, int Sq, int Skv, float scale, int causal,
                         cudaStream_t st) {
  const int ns = tf_stages(2), nsl = (chunks(D) + OWN - 1) / OWN;
  const size_t smem = tf_smem(ns, 2);
  auto kernel = flash_dkdv_sliced_tf32_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H * nsl, (Skv + kSlKeys - 1) / kSlKeys);
  kernel<<<grid, kSlThreads, smem, st>>>(
      m[0], m[1], m[2], m[3], p[0], p[1], p[2], p[3], lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Skv, D, nsl,
      ns, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dk/dv: Q and dO split into `work` (4·B·Sq·H·D floats), then the kernel
int dkdv_sliced_tf32(int D, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int H, int Sq, int Skv,
                     float scale, int causal, cudaStream_t st, float* work) {
  if (!work) return -1;
  CUtensorMap m[4], p[4];                  // q, k, v, dO raw; Q, dO parts
  if (int e = make_map(&m[0], q, B, Sq, H, D, 64, true)) return e;
  if (int e = make_map(&m[1], k, B, Skv, H, D, kSlKeys, true)) return e;
  if (int e = make_map(&m[2], v, B, Skv, H, D, kSlKeys, true)) return e;
  if (int e = make_map(&m[3], dout, B, Sq, H, D, 64, true)) return e;
  if (int e = tf_split(p, q, dout, work, B, Sq, H, D, st)) return e;
  // each warpgroup holds one accumulator of the whole slice: slices as
  // the bf16 kernels' (sl_own: 4 + 4 at D 512), one of every chunk up to
  // D 256 (half of one at D 32)
  switch (sl_own(chunks(D))) {
    case 1:
      return dkdv_sliced_tf32_own<1>(D, m, p, lse, delta, dk, dv, B, H, Sq,
                                     Skv, scale, causal, st);
    case 2:
      return dkdv_sliced_tf32_own<2>(D, m, p, lse, delta, dk, dv, B, H, Sq,
                                     Skv, scale, causal, st);
    case 3:
      return dkdv_sliced_tf32_own<3>(D, m, p, lse, delta, dk, dv, B, H, Sq,
                                     Skv, scale, causal, st);
    default:
      return dkdv_sliced_tf32_own<4>(D, m, p, lse, delta, dk, dv, B, H, Sq,
                                     Skv, scale, causal, st);
  }
}

}  // namespace tc

// dispatch on (dtype code, head dim): 0 = float32, 1 = bfloat16. float32
// runs the entry's F32 at every head dim the kernels are built for (32,
// 64, 128, 192, 256, and past 256 any multiple of 64): the 3xTF32
// tensor-core kernels, through the entry's tf32, which passes the
// workspace on. bfloat16 runs tc::FN<D> (tensor cores) at the head dims
// with kernels of their own and, past 256, WIDE_BF16 (the sliced
// tensor-core kernels)
#define BIGDL_FLASH_DISPATCH(FN, F32, WIDE_BF16, ...)                    \
  do {                                                                    \
    if (dtype == 0 && (D == 32 || D == 64 || D == 128 || D == 192 ||      \
                       D == 256 || (D > 256 && D % 64 == 0)))             \
      return F32(D, __VA_ARGS__);                                         \
    if (dtype == 1 && D == 32) return tc::FN<32>(__VA_ARGS__);            \
    if (dtype == 1 && D == 64) return tc::FN<64>(__VA_ARGS__);            \
    if (dtype == 1 && D == 128) return tc::FN<128>(__VA_ARGS__);          \
    if (dtype == 1 && D == 192) return tc::FN<192>(__VA_ARGS__);          \
    if (dtype == 1 && D == 256) return tc::FN<256>(__VA_ARGS__);          \
    if (dtype == 1 && D > 256 && D % 64 == 0)                             \
      return WIDE_BF16(D, __VA_ARGS__);                                   \
    return -1;                                                            \
  } while (0)

}  // namespace

// Each entry returns 0 on a clean launch, -1 for a (dtype, head dim) the
// kernels were not built for (or an f32 call given no workspace: the
// forward needs 2 floats an element of K, dq 4, dk/dv 4 an element of Q),
// -2 where no tensor-map encoder is found (cuTensorMapEncodeTiled), 1000
// + the CUresult of a refused tensor map, else the CUDA error code of the
// launch. The workspace comes last, after the stream.
extern "C" int bigdl_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o, float* lse, int B,
                               int H, int Sq, int Skv, int D, float scale,
                               int causal, void* stream, float* work) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // f32 at every D splits K into `work` first
  auto tf32 = [work](int D, auto... a) {
    return tc::fwd_sliced_tf32(D, a..., work);
  };
  BIGDL_FLASH_DISPATCH(fwd, tf32, tc::fwd_sliced, q, k, v, o, lse, B, H, Sq,
                       Skv, scale, causal, st);
}

extern "C" int bigdl_flash_dq(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* lse, const float* delta,
                              void* dq_out, int B, int H, int Sq, int Skv,
                              int D, float scale, int causal, void* stream,
                              float* work) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // f32 at every D splits K and V into `work` first
  auto tf32 = [work](int D, auto... a) {
    return tc::dq_sliced_tf32(D, a..., work);
  };
  BIGDL_FLASH_DISPATCH(dq, tf32, tc::dq_sliced, q, k, v, dout, lse, delta,
                       dq_out, B, H, Sq, Skv, scale, causal, st);
}

extern "C" int bigdl_flash_dkdv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, int B, int H, int Sq,
                                int Skv, int D, float scale, int causal,
                                void* stream, float* work) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // f32 at every D splits Q and dO into `work` first
  auto tf32 = [work](int D, auto... a) {
    return tc::dkdv_sliced_tf32(D, a..., work);
  };
  BIGDL_FLASH_DISPATCH(dkdv, tf32, tc::dkdv_sliced, q, k, v, dout, lse,
                       delta, dk, dv, B, H, Sq, Skv, scale, causal, st);
}

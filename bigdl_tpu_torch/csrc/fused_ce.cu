// Fused LM-head cross-entropy for Hopper (sm_90a): the forward (per-row
// nll and lse), dh, and dW with db, none of which writes an (N, V)
// tensor of logits or dlogits to device memory.
//
// Replaces the Pallas TPU kernels of bigdl_tpu/ops/pallas/fused_ce.py:
//   forward (+ fce_merge_kernel) <- `_fwd_kernel` (pl.pallas_call at 184)
//   dh                           <- `_dh_kernel`  (pl.pallas_call at 214)
//   dW and db                    <- `_dw_kernel`  (pl.pallas_call at 230)
// They compute the same functions, not the same programs:
//
//   s[n, v]  = h[n]·w[v] (f32 sums of products of the storage dtype T)
//              + b[v] (f32)
//   lse[n]   = logsumexp_v s[n, v],  nll[n] = lse[n] - s[n, t[n] - 1]
//   dl[n, v] = (exp(s[n, v] - lse[n]) - [v == t[n] - 1]) · g[n]    (f32)
//   dh[n]    = Σ_v T(dl[n, v]) · w[v]       (in T)
//   dW[v]    = Σ_n T(dl[n, v]) · h[n]       (in T),  db[v] = Σ_n dl[n, v]
//
// T(x) rounds x to T, as the TPU kernel rounds dlogits to W's dtype
// before dh and to h's dtype before dW (h and W share T here); db sums
// the unrounded f32 dlogits. Targets are 1-based; one outside [1, V]
// matches no column (nll = lse, zero one-hot in the backward).
//
// Every kernel walks "resident" rows R against tiles of "streamed" rows
// X: the forward and dh take R = token rows, X = vocab tiles; dW takes R
// = vocab rows, X = token tiles. For each X tile it forms the logits
// tile S = R·Xᵀ over the whole feature axis D, then either folds S into
// an online logsumexp (forward) or turns it into dlogits dl for the
// product dl·X (dh, dW). The TPU grid carries its state (the logsumexp,
// the dh / dW accumulator) across its sequential axis in VMEM scratch;
// here the axis is a loop inside the CTA and the state lives in
// registers, but for the bf16 backward past D 1024, which writes dl to a
// workspace a chunk of resident rows at a time and multiplies it by X in
// a second pass.
//
// Bound on the H100: at the harness shapes (N 8192, V 32768, D 1024,
// bf16) the forward does 2·N·V·D = 5.5e11 operations on 85 MB of inputs
// and each backward kernel twice that, thousands of operations a byte,
// far above the ~295 at which the tensor cores bind: all three are bound
// by operations (0.56 / 1.1 / 1.1 ms at 989 TFLOP/s). So in bf16 the
// products run on wgmma fed by TMA.
//
// Forward, bf16 (fce_fwd_tc_kernel): a GEMM with an online-logsumexp
// epilogue. Its only state is a logits tile and three floats a row, so
// D is the GEMM's K axis and is streamed; nothing is split across CTAs.
// - Tile: 128 token rows x 256 vocab columns a CTA; two consumer
//   warpgroups of 64 rows each hold a 64 x 256 f32 accumulator (128
//   registers a thread) and run wgmma m64n256k16, both operands K-major
//   in shared memory with the 128-byte swizzle.
// - Loads: one thread of a producer warpgroup (384 threads a CTA) streams
//   (vocab tile, 64-column D box) pairs in order through a 4-stage ring:
//   per stage an h box [128][64] (16 KB) and a W box [256][64] (32 KB) by
//   TMA from 2-D tensor maps, full/empty mbarriers. The ring runs
//   straight across vocab tiles, so the next tile's first boxes load
//   while this tile's epilogue runs. The maps zero-fill rows past N or V
//   and columns past D, so any D that is a multiple of 8 works (D 72:
//   two boxes). setmaxnreg hands the producer's registers to the
//   consumers (40 / 232 a thread): with a lone producer warp (288
//   threads) a scheduler holds three of the nine warps and ptxas caps
//   every thread at 168 registers, too few for the accumulator and the
//   epilogue (fused_ce_knockout.py times that design).
// - Products: per box four wgmma per warpgroup, one commit group; the
//   previous box's group is waited for (wait_group 1) and its stage
//   released, so one box's products overlap the next box's issue. The
//   accumulator starts each tile through wgmma's scale-d flag, not by
//   assignment (an instruction defining it in a group's window makes
//   ptxas serialise the products).
// - Epilogue, in registers: add the bias and mask columns past V to
//   -inf, pick out the target logit, take the row max over the four
//   lanes that share a row, rescale and add the tile's exps (ex2 of one
//   FMA each). After the walk, (max, sum of exp, target logit) go to the
//   split's partials for fce_merge_kernel. The tile's bias is loaded
//   into registers before its products: loaded in the epilogue, its
//   latency stood unhidden there. The epilogue does not overlap the
//   products (both warpgroups fold at once); delaying one warpgroup by
//   up to three ring stages, so that one folds while the other's
//   products run, measured no faster.
// - What bounds it: the products, about four fifths of its time; the
//   epilogue and the loads' waits share the rest (fused_ce_knockout.py,
//   PERF.md).
// - Grid: N/128 row tiles x vocab splits (fwd_splits: one CTA per SM,
//   128 CTAs at N 8192 and at N 1000). The CTAs of one split walk the
//   same W tiles in step, so W crosses HBM about once per split and h
//   stays in L2.
//
// Backward, bf16 with D <= 1024 (fce_bwd_tc_kernel): thread-block
// clusters of four CTAs on four SMs; CTA q of a cluster owns feature
// columns [256q, 256q + 256). The D-wide f32 accumulator — the TPU's
// (512, D) and (1024, D) f32 VMEM tiles — does not fit one SM (256 KB of
// registers), so each CTA keeps a quarter of it and the partial logits
// are summed across the cluster. 128 resident rows per cluster, two
// consumer warpgroups of 64 rows in each CTA (256 threads).
// - Loads: the CTA's R slice (128 x 256 bf16, 64 KB) once by TMA, as four
//   [128][64] boxes of 128-byte swizzled rows; X tiles (64 x 256, 32 KB)
//   through a 3-stage ring with full mbarriers. Thread 0 issues the load
//   of tile t + 2 right after tile t's first cluster barrier, by which
//   every warp of the CTA has finished the products that read the stage
//   (the cluster barriers already order all warps twice a tile, so a
//   producer warp could run no further ahead, and registers stay with the
//   consumers: no setmaxnreg). The 2-D tensor maps (D, rows) zero-fill
//   rows past N or V and columns past D; a 64-column box that lies wholly
//   past D is not loaded, its shared memory zeroed once.
// - Partial logits: each warpgroup forms its 64 x 64 partial S of tile t
//   (32 f32 a thread) with wgmma m64n64k16 over 16 K steps, both operands
//   K-major, and stores it to the CTA's f32 tile (128 x 64). Tile t + 1's
//   partial products are issued while the cluster gathers tile t's dl.
// - Cluster sum: after a cluster barrier CTA q sums rows [32q, 32q + 32)
//   of the four CTAs' tiles through distributed shared memory in rank
//   order, forms dl in f32, rounds it to bf16 and writes it into all four
//   CTAs' 128 x 64 dl tile (128-byte swizzled rows); a second cluster
//   barrier follows. db sums the unrounded dl per row.
// - Accumulate: each warpgroup loads its 64 dl rows as A fragments
//   (ldmatrix) and adds dl·X_slice into its 64 x 256 f32 accumulator (128
//   registers a thread) with wgmma m64n256k16, X read MN-major (its 256
//   columns as four 64-wide chunks). dl from registers, not shared
//   memory: wgmma would read the tile through the async proxy, which
//   needs a proxy fence after the remote writes, and that fence cost a
//   tenth of the kernel's time.
// - Two cluster barriers per 128 resident rows, and each X element
//   crosses L2 once per cluster. What bounds the kernel is the exchange,
//   not the tensor cores: its barriers and reads of remote partials take
//   about two thirds of the time (scripts/fused_ce_knockout.py). Pushing
//   the partials (remote stores, bulk copies, st.async with mbarriers) in
//   place of reading them measured no faster; overlapping one tile's
//   exchange with another's products needs a second set of exchange
//   buffers, for which shared memory has no room.
// - Waves: an H100 holds 30 such clusters at once. dW runs V/128 of them
//   (256 at V 32768: 8.5 waves' work in 9). dh's N/128 (64 at N 8192)
//   would fill waves of 30, 30 and 4, so dh splits its vocab walk into S
//   parts (dh_splits: the S in 1..4 with the fewest whole-walk waves, 4
//   here: 256 quarter walks in 9 waves), each writing f32 partial sums
//   that fce_dh_merge_kernel adds in split order and rounds to bf16.
// - Sums are f32 in a fixed order (no atomics): deterministic.
//
// Backward, f32, every D (tf::fce_bwd_tf32_kernel<kVocabRows>): 3xTF32
// on the tensor cores (tf32.cuh, shared with the f32 flash kernels).
// - Why. Each backward kernel forms the logits again: 4·N·V·D = 1.1e12
//   operations at the harness head (N 8192, V 32768, D 1024), 16.4 ms at
//   the CUDA cores' 67 TFLOP/s, so no CUDA-core pair (32.8 ms) can beat
//   the library's whole f32 backward (23.2 ms: F.cross_entropy over
//   F.linear, TF32 off; chip_smoke.py's library_ms). One TF32 product
//   keeps 11 of f32's 24 bits and misses the f32 limits; x = hi + lo, hi
//   = tf32(x), lo = tf32(x - hi), and hi·lo + lo·hi + hi·hi on wgmma
//   m64n64k8 keeps about 22, three products a multiply: 6.66 ms a kernel
//   at 495 TFLOP/s.
// - Roles, as in the f32 flash forward. A CTA holds 64 resident rows R
//   (token rows for dh, vocab rows for dW) and walks 64-row tiles of X.
//   A producer warpgroup (setmaxnreg 24 / 240) streams a 3-stage ring of
//   six [64][32] f32 boxes (48 KB) by TMA from 2-D maps: per score step
//   of 32 columns, R's raw box and X's tf32 parts (hi, lo) for each of
//   the two consumer warpgroups; per output step, X's raw columns of
//   each warpgroup's 64-column chunk. A split pass (tf32_split_kernel)
//   writes X's parts to a workspace first (2·nX·D floats: W's 256 MiB
//   for dh, h's 64 MiB for dW at the harness head).
// - The logits. Each warpgroup sums its share of S = R·Xᵀ over D
//   (tf_score_step: A split in registers, a fresh sum every 2 K steps);
//   warpgroup 1 hands its half to warpgroup 0 (named barrier 1).
// - The D-wide accumulator. A 64-row f32 accumulator of D 1024 is 256
//   KB, an SM's registers. Clusters of two CTAs each own 512 output
//   columns (4 chunks a warpgroup, 128 registers a thread) and sum the
//   logits over half of D; warpgroup 0 of each puts its CTA's 64 x 64
//   partial into the other's shared memory (st.shared::cluster, then an
//   mbarrier arrival released to the cluster; two buffers, so a CTA
//   waits only until the other has read the tile before last) and adds
//   the other's from its own: the same f32 sums in both CTAs, the logits
//   formed once. Forming them in each CTA over all of D instead (no
//   exchange, 1.5x the products) took 1.35-1.42x (dh) and 1.33-1.38x
//   (dW) the time (fused_ce_knockout.py --only tf32,
//   recompute_per_slice; NVIDIA H100 80GB HBM3, 700 W). Past D 1024 a
//   row block takes ceil(D / 1024) clusters, each forming the logits
//   over all of D for its columns (D 1032: two of 5 + 5 chunks a CTA).
// - The epilogue. Warpgroup 0 forms dl = (exp(s + b - lse) - onehot)·g
//   in f32 from the column values warpgroup 1 loaded under its score
//   steps and staged in shared memory (dh: the bias; dW: lse, g and the
//   target column), adds the unrounded dl to db's sums (two rows a
//   thread, the lane quad added at the end) and puts dl's tf32 parts in
//   shared memory (barrier 2).
// - The output, transposed: dhᵀ = Xᵀ·dlᵀ, dWᵀ = Xᵀ·dl (tf_out_step: A
//   X's raw columns split in registers, B dl's parts, K-major as the
//   accumulator lays them; a fresh sum every 4 K steps), stored element
//   by element at the end; dh's split walks (dh_splits) into f32
//   partials that fce_dh_merge_kernel adds in split order.
// - Numbers at the harness head, held to the function in float64 (as a
//   fraction of chip_smoke.py's f32 limits): dh 0.11, dW 0.08, db 0.05.
//   The output products chained over the walked tiles (no fresh sums)
//   read 5.6x and 2.3x the limit; the score products chained over D
//   read the same as the kept fresh sums here (dl does not cancel as
//   flash's dS does) and 0.95-0.99x the time, but tf32.cuh's steps are
//   the flash kernels' too, and the fresh sums stay.
// - Pace (15.3-15.4 ms a kernel, 43 % of the 3xTF32 bound): no one part.
//   With one taken out at a time (fused_ce_knockout.py): the output
//   steps' products 0.75-0.78x, the score steps' 0.85-0.86x, A's split
//   in registers 0.88-0.90x, dl's formation 0.89-0.91x, the exchange
//   0.98x (dh) and 0.90x (dW), the TMA loads (L2 traffic) 0.97-0.98x.
//   Half the products gone saves a sixth to a quarter of the time: the
//   warpgroups wait on each fresh sum's wgmma and on each other (the
//   epilogue runs while warpgroup 1 waits at barrier 2), not on L2.
// - Waves. 256 CTAs (128 clusters) at N 8192 fill two waves of one CTA
//   an SM; dh splits its vocab walk only where that lowers the whole-walk
//   waves (4 parts at N 1000; none at N 8192).
//
// Forward, f32, every D (tf::fce_fwd_tf32_kernel): 3xTF32 on the tensor
// cores (tf32.cuh's split and ring) with the bf16 forward's epilogue.
// - Why. 2·N·V·D = 5.5e11 operations at the harness head take 8.2 ms at
//   the CUDA cores' 67 TFLOP/s, so no CUDA-core kernel (28.6 ms, the one
//   this replaced) can beat the library's f32 forward (12.0 ms:
//   F.cross_entropy over F.linear, TF32 off). One TF32 product misses
//   the f32 limit on nll; hi·lo + lo·hi + hi·hi keeps it: 3.33 ms at 495
//   TFLOP/s.
// - Tile and roles. A CTA holds 128 token rows, two consumer warpgroups
//   of 64, and walks vocab tiles of 128 columns; a producer warpgroup
//   (setmaxnreg 24 / 240) streams a 4-stage ring of 48 KB stages by TMA
//   from 2-D f32 maps: per score step of 32 columns of D, h's raw box
//   [128][32] and W's tf32 parts (hi, lo) [128][32] each. Both operands
//   are K-major as stored (D is contiguous in h and in W), so no product
//   needs a transpose. tf32_split_kernel writes W's parts to a workspace
//   first (2·V·D floats: 256 MiB at the harness head).
// - Products. A warpgroup splits its 64 rows of h's box into tf32 parts
//   in registers and sums the step's 12 wgmma m64n128k8 in a fresh
//   accumulator that the logits tile gains in f32: a 64 x 128 tile and
//   its fresh sum take 128 registers a thread, A's parts 32 and the
//   tile's bias 32.
// - Epilogue: tc::fold, as the bf16 forward (bias, -inf past V, target
//   logit, ex2 of one FMA, four chains a row); (max, sum of exp, target
//   logit) of each row go to the split's partials for fce_merge_kernel.
// - Grid: N/128 row tiles x vocab splits, one CTA an SM (vocab_splits),
//   the CTAs of a split walking the same W tiles in step.
//
// Backward, bf16 with D > 1024 (tc::fce_dl_tc_kernel<kVocabRows>, then
// tc::fce_gemm_tc_kernel): two passes over chunks of resident rows, with
// no D-wide accumulator.
// - Why. The cluster kernel's R slice (128 rows x 256 columns a CTA)
//   covers D 1024 in a cluster of four. Past it, a wider accumulator
//   means more exchange (what bounds the cluster kernel) or the logits
//   formed again for every slice of D. A reduction across blocks takes a
//   second pass instead: dl goes to device memory and comes back as a
//   GEMM operand.
// - Pass 1, dl (fce_dl_tc_kernel): the forward's GEMM, tile, ring and
//   roles (128 R rows x 256 X columns a CTA, two consumer warpgroups of
//   wgmma m64n256k16, a producer warpgroup streaming the 4-stage TMA
//   ring, setmaxnreg 40 / 232) with a dl epilogue in registers: dl =
//   (2^((s + b)·log2 e - lse·log2 e) - onehot)·g in f32, zero past nR
//   and nX, rounded to bf16 and stored 4 bytes (two columns) at a time
//   straight from the accumulator's layout into the chunk buffer
//   dl[rows][nXp] (nXp: nX rounded up to 8, for TMA's 16-byte pitch),
//   row-major: K-major for pass 2 in dh and dW alike. A second producer
//   warp stages each tile's column values in shared memory (dh: the
//   bias; dW: each token's lse·log2 e, g and target column), two slots
//   under full and empty mbarriers. dW also sums each vocab row's
//   unrounded dl over the tile's 256 tokens (the lane quad's shares) into
//   one f32 partial a (row, token tile); fce_db_merge_kernel adds them in
//   tile order.
// - Pass 2, out = dl·X (fce_gemm_tc_kernel, one kernel for dh and dW): 128
//   output rows x 256 columns a CTA, the forward's roles and ring; A the
//   dl chunk, K-major [128][64] boxes; B X's [64][64] boxes, read
//   MN-major (wgmma's transposed B, four 64-column chunks); K is the
//   whole walk, so each output is one f32 sum in registers, rounded to
//   bf16 once. X boxes wholly past D are not loaded: the columns they
//   feed are never stored.
// - Chunks: the most 128-row tiles whose bf16 dl fits the workspace's
//   kChunkBytes beside dW's db partials (chunk_rows); the wrapper
//   allocates the workspace (ops.fused_ce.workspace_floats). Two
//   launches a chunk, and the db merge for dW.
// - Bound: operations, 4·N·V·D a kernel as the TPU's pair (each forms the
//   logits once more), with the dl chunks' round trip (2·N·V bytes
//   written and read back per kernel) beside them. At N 8192 V 32768 D
//   2048 dh takes 3.07-3.35 ms and dW 3.58-3.65, 61-72 % of the 2.22 ms
//   bound (chip_smoke.py, fused_ce_knockout.py --only chunked, PERF.md;
//   NVIDIA H100 80GB HBM3, 700 W). Pass 1 alone is 0.53-0.58 of the
//   pair, pass 2 alone 0.45-0.47. Neither the loads nor the epilogue set
//   the pace: with no TMA loads a pass saves 5-8 %, with no exps nothing,
//   with no dl stores 1-6 % (so a staged TMA store could save no more);
//   the products themselves run at 58-69 % of the card's peak. A
//   workspace of 64 MiB leaves dh's pass 2 64 CTAs on 132 SMs (1.32-1.36x).
// - Sums are f32 in a fixed order (no atomics): deterministic.
//
// Both forwards may split the vocab across a further grid axis so that a
// few rows still fill the card; fce_merge_kernel merges the per-split
// (max, sum of exp, target logit) of each row into nll and lse. The
// kernels allocate nothing: the Python wrapper (ops/fused_ce.py)
// allocates outputs, the forward's and dh's partials and the f32
// kernels' workspace, and checks shapes,
// dtypes, contiguity and alignment. Any N, any V, D a multiple of 8
// (16-byte rows for cp.async and the tensor maps); ragged tiles are
// zero-filled and masked.

#include <cooperative_groups.h>
#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"       // mbarriers, TMA, wgmma, tensor maps
#include "tf32.cuh"         // the 3xTF32 steps, ring and split pass

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using hopper::set_smem;

constexpr int kThreads = 256;
constexpr int kX = 64;        // streamed rows per tile (both paths)

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&x)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&a);
  v.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}

template <int kLanes>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int kLanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void fce_merge_kernel(const float* __restrict__ part, int splits,
                                 int N, float* __restrict__ nll,
                                 float* __restrict__ lse) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const int64_t plane = static_cast<int64_t>(splits) * N;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m = fmaxf(m, part[static_cast<int64_t>(s) * N + row]);
  float l = 0.f, tl = 0.f;
  for (int s = 0; s < splits; ++s) {
    const int64_t at = static_cast<int64_t>(s) * N + row;
    l += part[plane + at] * expf(part[at] - m);   // an empty split: 0·0
    tl += part[2 * plane + at];
  }
  const float out = m + logf(l);
  lse[row] = out;
  nll[row] = out - tl;
}

// nll and lse from the forward's `splits` partials
int merge(const float* part, int splits, int N, float* nll, float* lse,
          cudaStream_t st) {
  fce_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, splits, N, nll,
                                                     lse);
  return static_cast<int>(cudaGetLastError());
}

// dl of logit s at (resident row, streamed column) — which of the two is
// the token depends on the kernel
__device__ __forceinline__ float dlogit(float s, float lse, float g,
                                        bool target) {
  return (expf(s - lse) - (target ? 1.f : 0.f)) * g;
}

// dh = the split walks' f32 partial sums added in split order, in T (n
// elements, a multiple of 4)
template <typename T>
__global__ void fce_dh_merge_kernel(const float* __restrict__ part,
                                    int splits, int64_t n,
                                    T* __restrict__ out) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) * 4;
  if (i >= n) return;
  float x[4], y[4];
  load4(part + i, x);
  for (int z = 1; z < splits; ++z) {
    load4(part + z * n + i, y);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] += y[e];
  }
  store4(out + i, x);
}

template <typename T>
int dh_merge(const float* part, int splits, int64_t n, T* out,
             cudaStream_t st) {
  fce_dh_merge_kernel<T><<<static_cast<unsigned>((n / 4 + 255) / 256), 256,
                           0, st>>>(part, splits, n, out);
  return static_cast<int>(cudaGetLastError());
}

// How many walks a dh kernel splits the vocab into: the clusters the
// card holds at once come in waves, and `rows` clusters of a whole walk
// each may leave the last wave nearly empty; S walks of a part each,
// their f32 partial sums added by fce_dh_merge_kernel, take the S in 1..4
// (no more than the walk's `tiles`) with the fewest whole-walk waves,
// ceil(S·rows / clusters) / S (1 where the runtime cannot say)
int walk_splits(int rows, int tiles, int clusters) {
  int best = 1;
  for (int s = 2; s <= 4 && s <= tiles && clusters > 0; ++s)
    if (((rows * s + clusters - 1) / clusters) * best <
        ((rows * best + clusters - 1) / clusters) * s)
      best = s;
  return best;
}

// the vocab splits of a forward of CTAs of `rows` token rows walking
// tiles of `cols` vocab columns: as many as keep one CTA on every SM of
// the card's `sms` at once, no more than the vocab tiles
int vocab_splits(int N, int V, int rows, int cols, int sms) {
  const int ctas = (N + rows - 1) / rows;
  return max(1, min((V + cols - 1) / cols, sms / ctas));
}

// clusters of `kernel` (launched with `threads` and `smem`, its cluster
// `ranks` CTAs along x, or along y where `along_y`) the card holds at
// once, 0 if the runtime cannot say
template <typename Kernel>
int max_clusters(Kernel kernel, int ranks, bool along_y, int threads,
                 size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = along_y ? dim3(1, ranks) : dim3(ranks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  if (set_smem(kernel, smem) ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();                    // clear it: no split, no error
    return 0;
  }
  return n;
}

// (rows, D) bf16 at ptr as a 2-D (D, rows) map with boxes (64, box_rows),
// the 128-byte swizzle; f32: boxes of (32, box_rows), the same 128-byte
// rows; reads past either edge fill zeros. Rows lie `pitch` elements
// apart (a multiple of 16 bytes), D where it is 0.
int make_map(CUtensorMap* map, const void* ptr, int rows, int D,
             int box_rows, bool f32 = false, int pitch = 0) {
  const hopper::EncodeTiled enc = hopper::encode_tiled();
  if (!enc) return hopper::kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch ? pitch : D) *
                                 (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {f32 ? 32u : 64u,
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map,
                         f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::kMapFailed + static_cast<int>(r);
}

// ===========================================================================
// bf16: tensor cores (wgmma) fed by TMA
// ===========================================================================

constexpr int kRanks = 4;             // CTAs of a backward cluster
constexpr int kSlice = 256;           // feature columns per backward CTA
constexpr int kClusterD = kRanks * kSlice;

// four 8 x 8 bf16 matrices from shared memory; lane i gives the address
// of row i % 8 of matrix i / 8, lane t receives row t / 4, columns
// 2(t % 4) .. +1 of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// ---------------------------------------------------------------------------
// backward (dh; dW and db): wgmma fed by TMA, 128 resident rows per cluster
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;            // resident rows per cluster
constexpr int kChunks = kSlice / 64;  // 64-column boxes of a CTA's slice
constexpr int kStages = 3;            // ring of X tiles
constexpr int kPP = kX + 8;           // pitch (f32) of the partial S tile

// shared memory (bytes from the 1024-aligned base): the R slice, the X
// ring, the partial S tile (f32), the dl tile (bf16, swizzled), barriers
constexpr int kRBytes = kRows * kSlice * 2;
constexpr int kXBytes = kX * kSlice * 2;
constexpr int kOffX = kRBytes;
constexpr int kOffP = kOffX + kStages * kXBytes;
constexpr int kOffG = kOffP + kRows * kPP * 4;
constexpr int kBarsAt = kOffG + kRows * kX * 2;
constexpr size_t kSmem = 1024 + kBarsAt + 8 * (2 * kStages + 1);
static_assert(kOffG % 1024 == 0, "the dl tile is one swizzle-aligned tile");
static_assert(kSmem <= 232448, "more shared memory than a CTA may have");

// this warpgroup's partial logits of an X tile: s (64 x 64) = R rows
// [64wg, 64wg + 64) of the slice · X tileᵀ, 16 K steps of 16 columns
__device__ __forceinline__ void partial(float (&s)[32], uint32_t rs,
                                        uint32_t xs, int wg) {
#pragma unroll
  for (int kk = 0; kk < kSlice / 16; ++kk)
    wgmma_ss_n64(s, desc_k<kRows>(rs, 64 * wg, kk), desc_k<kX>(xs, 0, kk),
                 kk > 0);
}

// this warpgroup's dl rows [64wg, 64wg + 64) of the swizzled dl tile G
// as the A fragments of 4 K steps (ldmatrix: generic loads, which the
// cluster barrier orders after the remote writes; a wgmma operand read
// from shared memory would need a proxy fence after them)
__device__ __forceinline__ void dl_frags(uint32_t (&a)[kX / 16][4],
                                         const unsigned char* G, int wg) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int r = 64 * wg + 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kX / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);    // 16-byte chunk of the row
    ldsm4(a[kk], reinterpret_cast<const bf16*>(
                     G + r * kRowBytes + ((c ^ (r % 8)) * 16)));
  }
}

// acc (64 x 256) += dl (64 x 64, A fragments in registers) · the X tile's
// slice (64 x 256, read MN-major), 4 K steps of 16 X rows
__device__ __forceinline__ void accumulate(float (&acc)[128],
                                           const uint32_t (&a)[kX / 16][4],
                                           uint32_t xs) {
#pragma unroll
  for (int kk = 0; kk < kX / 16; ++kk)
    wgmma_rs_n256_tb(acc, a[kk], desc_mn_wide<kX>(xs, kk));
}

// X tile t0 + i, the walk's i-th, into its ring stage: the slice's nc
// boxes of [64][64]
__device__ __forceinline__ void load_x(const Ring<kStages>& ring,
                                       const CUtensorMap* xm, int t0, int i,
                                       int nc, int d0) {
  const int st = i % kStages;
  const uint32_t dst = ring.base + kOffX + st * kXBytes;
  bar_expect(ring.full(st), nc * kX * kRowBytes);
  for (int c = 0; c < nc; ++c)
    tma_load_2d(dst + c * kX * kRowBytes, xm, ring.full(st), d0 + 64 * c,
                (t0 + i) * kX);
}

template <bool kVocabRows>
__global__ void __cluster_dims__(1, kRanks, 1) __launch_bounds__(kThreads, 1)
fce_bwd_tc_kernel(const __grid_constant__ CUtensorMap rm,
                  const __grid_constant__ CUtensorMap xm,
                  const float* __restrict__ b, const int* __restrict__ tgt,
                  const float* __restrict__ lse,
                  const float* __restrict__ g, bf16* __restrict__ out,
                  float* __restrict__ part, float* __restrict__ db, int N,
                  int V, int D) {
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Ring<kStages> ring =
      make_ring<kStages>(smem_raw, kBarsAt, kThreads / 32);
  unsigned char* const base = smem_raw + (ring.base - smem_u32(smem_raw));
  float* const P = reinterpret_cast<float*>(base + kOffP);
  unsigned char* const G = base + kOffG;
  const uint32_t rs = ring.base, xs0 = ring.base + kOffX;

  const int rank = static_cast<int>(cluster.block_rank());
  const int d0 = rank * kSlice;
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;
  const int r0 = blockIdx.x * kRows;
  // this walk's X tiles [t0, t0 + nxt): split z of gridDim.z (balanced,
  // none empty: the launcher takes no more splits than tiles)
  const int all = (nX + kX - 1) / kX;
  const int t0 = blockIdx.z * all / gridDim.z;
  const int nxt = (blockIdx.z + 1) * all / gridDim.z - t0;
  // boxes of this slice that hold a column below D; the rest stay zero
  const int nc = max(0, min(kChunks, (D - d0 + 63) / 64));
  const int tid = threadIdx.x, wg = tid / 128, l = tid % 32;
  // accumulator row of element 0 (local to the cluster's 128)
  const int arow = 64 * wg + 16 * ((tid / 32) % 4) + l / 4;

  if (nc < kChunks) {
    constexpr int kVecs = kRowBytes / 16;  // uint4 a swizzled row
    for (int i = tid; i < (kChunks - nc) * kRows * kVecs; i += kThreads)
      reinterpret_cast<uint4*>(base + nc * kRows * kRowBytes)[i] = uint4{};
    for (int st = 0; st < kStages; ++st)
      for (int i = tid; i < (kChunks - nc) * kX * kVecs; i += kThreads)
        reinterpret_cast<uint4*>(base + kOffX + st * kXBytes +
                                 nc * kX * kRowBytes)[i] = uint4{};
    fence_proxy_async();
  }
  __syncthreads();

  if (tid == 0) {
    bar_expect(ring.once(), nc * kRows * kRowBytes);
    for (int c = 0; c < nc; ++c)
      tma_load_2d(rs + c * kRows * kRowBytes, &rm, ring.once(), d0 + 64 * c,
                  r0);
    for (int i = 0; i < min(kStages - 1, nxt); ++i)
      load_x(ring, &xm, t0, i, nc, d0);
  }
  __syncwarp();

  // the epilogue's row (local er, of this CTA's 32) and 8 columns ec ..
  const int er = 32 * rank + tid / 8, ec = 8 * (tid % 8);
  const int erow = r0 + er;
  const bool row_ok = erow < nR;
  // dh: the resident row is the token (its lse, g and target); dW: the
  // vocab entry (its bias)
  const float row_lse = !kVocabRows && row_ok ? lse[erow] : 0.f;
  const float row_g = !kVocabRows && row_ok ? g[erow] : 0.f;
  const int row_t = !kVocabRows && row_ok ? tgt[erow] - 1 : -1;
  const float row_b = kVocabRows && row_ok ? b[erow] : 0.f;
  float db_sum = 0.f;

  // Registers that wgmma writes are pinned (keep) before the first
  // product group and after each wait, so that no other instruction
  // defines them while a group is in flight (ptxas would serialise the
  // products).
  float acc[128], s[32];
  uint32_t a[kX / 16][4] = {};
  zero(acc);
  zero(s);
  keep(acc);
  keep(s);
  warp_wait(ring.once(), 0);
  warp_wait(ring.full(0), 0);
  wg_fence();
  partial(s, rs, xs0, wg);
  wg_commit();

  for (int t = 0; t < nxt; ++t) {
    const uint32_t xs = xs0 + (t % kStages) * kXBytes;
    wg_wait();
    keep(acc);
    keep(s);
    keep(a);
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(P + (arow + acc_row(i)) * kPP +
                                 acc_col(i, l)) = make_float2(s[i], s[i + 1]);
    cluster_arrive();
    // the tile's column values, loaded in the barrier's shadow (into the
    // registers s held): dh the vocab bias; dW each token's lse, g and
    // target
    float cb[8], cl[8], cg_[8];
    int ct[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = (t0 + t) * kX + ec + e;
      const bool ok = x < nX;
      cb[e] = !kVocabRows && ok ? b[x] : 0.f;
      cl[e] = kVocabRows && ok ? lse[x] : 0.f;
      cg_[e] = kVocabRows && ok ? g[x] : 0.f;
      ct[e] = kVocabRows && ok ? tgt[x] - 1 : -1;
    }
    // the four partials are complete, and every product of tile t - 1 is
    // done: its X stage is free
    cluster_wait();
    if (tid == 0 && t + kStages - 1 < nxt)
      load_x(ring, &xm, t0, t + kStages - 1, nc, d0);
    __syncwarp();

    float sv[8] = {};
#pragma unroll
    for (int q = 0; q < kRanks; ++q) {
      const float* part = cluster.map_shared_rank(P, q) + er * kPP + ec;
      const float4 lo = *reinterpret_cast<const float4*>(part);
      const float4 hi = *reinterpret_cast<const float4*>(part + 4);
      sv[0] += lo.x; sv[1] += lo.y; sv[2] += lo.z; sv[3] += lo.w;
      sv[4] += hi.x; sv[5] += hi.y; sv[6] += hi.z; sv[7] += hi.w;
    }
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float dl[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int x = (t0 + t) * kX + ec + e + u;
        dl[u] = 0.f;
        if (row_ok && x < nX)
          dl[u] = kVocabRows
                      ? dlogit(sv[e + u] + row_b, cl[e + u], cg_[e + u],
                               ct[e + u] == erow)
                      : dlogit(sv[e + u] + cb[e + u], row_lse, row_g,
                               x == row_t);
        db_sum += dl[u];
      }
      packed[e / 2] = pack_bf16(dl[0], dl[1]);
    }
    // row er, 16-byte chunk tid % 8 of its 128-byte row, 128-byte swizzle
    const int off = er * kRowBytes + (((tid % 8) ^ (er % 8)) * 16);
    const uint4 v = make_uint4(packed[0], packed[1], packed[2], packed[3]);
#pragma unroll
    for (int q = 0; q < kRanks; ++q)
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(G, q) + off) = v;
    cluster_arrive();
    // the next tile's partial logits run while the cluster gathers the dl
    // tiles; the last tile repeats its own (a product every tile, so no
    // branch around the products)
    const int tn = min(t + 1, nxt - 1);
    if (tn > t) warp_wait(ring.full(tn % kStages), (tn / kStages) & 1);
    keep(s);
    wg_fence();
    partial(s, rs, xs0 + (tn % kStages) * kXBytes, wg);
    wg_commit();
    cluster_wait();                        // every CTA's dl tile is complete
    dl_frags(a, G, wg);
    wg_fence();
    accumulate(acc, a, xs);
    wg_commit();
  }
  wg_wait();
  keep(acc);

  // this warpgroup's 64 rows of this CTA's 256 columns: in bf16, or in
  // f32 into the split's partial sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + arow + 8 * r;
    if (row >= nR) continue;
    const int64_t at = (static_cast<int64_t>(blockIdx.z) * nR + row) * D + d0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * (l % 4);
      if (d0 + c >= D) continue;           // D a multiple of 8: c + 1 too
      const float lo = acc[4 * j + 2 * r], hi = acc[4 * j + 2 * r + 1];
      if (gridDim.z == 1)
        *reinterpret_cast<uint32_t*>(out + at + c) = pack_bf16(lo, hi);
      else
        *reinterpret_cast<float2*>(part + at + c) = make_float2(lo, hi);
    }
  }
  if (kVocabRows) {                        // the row's db, over its 8 lanes
    const float sum = group_sum<8>(db_sum);
    if (tid % 8 == 0 && row_ok) db[erow] = sum;
  }
}

// ---------------------------------------------------------------------------
// forward: a GEMM with an online-logsumexp epilogue, 128 token rows a CTA
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;         // token rows per CTA
constexpr int kFwdCols = 256;         // vocab columns per tile
constexpr int kFwdStages = 4;         // ring of (h box, W box) pairs
constexpr int kConsumers = 256;       // two warpgroups of 64 rows
constexpr int kFwdThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // setmaxnreg
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536,
              "more registers than an SM holds");
constexpr int kHBox = kFwdRows * kRowBytes;    // [128][64] bf16
constexpr int kWBox = kFwdCols * kRowBytes;    // [256][64] bf16
constexpr int kFwdStage = kHBox + kWBox;
using FwdLayout = Layout<kFwdStages, 0, kFwdStage>;
static_assert(FwdLayout::kSmem <= 232448,
              "more shared memory than a CTA may have");

// this thread's bias pairs of a vocab tile of 8J columns (columns c0 +
// 8j, +1; c0 even), -inf past V. Loaded when the tile's products start,
// so that the loads' latency hides behind them, not in the epilogue.
template <int J>
__device__ __forceinline__ void load_bias(float2 (&bias)[J],
                                          const float* __restrict__ b,
                                          int V, int v0, int c0) {
  if (v0 + 8 * J <= V) {                   // every column in the vocab
#pragma unroll
    for (int j = 0; j < J; ++j)
      bias[j] = __ldg(reinterpret_cast<const float2*>(b + c0 + 8 * j));
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = c0 + 8 * j;
      bias[j].x = c < V ? __ldg(b + c) : -INFINITY;
      bias[j].y = c + 1 < V ? __ldg(b + c + 1) : -INFINITY;
    }
  }
}

// Fold one logits tile of 8J columns into its rows' online logsumexp.
// This thread holds 2 rows x 2J columns of the tile's accumulator (rows h
// = 0, 1 at +8h, columns c0 + 8j + e, c0 = v0 + 2(lane % 4)): add the
// bias (-inf past V, which masks those columns), add the target column's
// logit to tl, then rescale the rows' sums of exp to the new row max,
// taken over the four lanes of the row, and add this thread's exps. m is
// the same in the four lanes; ls and tl are this lane's shares. Maxima
// and sums run in four independent chains a row, so that two warps a
// scheduler are not bound by the latency of one chain of 2J.
template <int J>
__device__ __forceinline__ void fold(float (&acc)[4 * J],
                                     const float2 (&bias)[J], int c0,
                                     const int (&tcol)[2], float (&m)[2],
                                     float (&ls)[2], float (&tl)[2]) {
  constexpr float kLog2e = 1.4426950408889634f;
  float mx[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) mx[h][k] = -INFINITY;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& s0 = acc[4 * j + 2 * h];
      float& s1 = acc[4 * j + 2 * h + 1];
      s0 += bias[j].x;
      s1 += bias[j].y;
      mx[h][j % 4] = fmaxf(mx[h][j % 4], fmaxf(s0, s1));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the target's logit, in the one tile of the walk that holds it
    if (static_cast<unsigned>(tcol[h] - c0) < 8 * J) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * j + e == tcol[h]) tl[h] += acc[4 * j + 2 * h + e];
    }
    const float tile = fmaxf(fmaxf(mx[h][0], mx[h][1]),
                             fmaxf(mx[h][2], mx[h][3]));
    const float m_new = fmaxf(m[h], group_max<4>(tile));
    ls[h] *= ex2((m[h] - m_new) * kLog2e);   // 0 before the first tile
    m[h] = m_new;
  }
  float sum[2][4] = {};
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
  for (int i = 0; i < 4 * J; ++i) {
    const int h = (i % 4) / 2;
    sum[h][(i / 4) % 4] += ex2(fmaf(acc[i], kLog2e, -ml[h]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    ls[h] += (sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]);
}

__global__ void __launch_bounds__(kFwdThreads, 1)
fce_fwd_tc_kernel(const __grid_constant__ CUtensorMap hm,
                  const __grid_constant__ CUtensorMap wm,
                  const float* __restrict__ b, const int* __restrict__ tgt,
                  float* __restrict__ part, int N, int V, int D) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<kFwdStages> ring =
      make_ring<kFwdStages>(smem_raw, FwdLayout::kBars, kConsumers / 32);
  const int r0 = blockIdx.x * kFwdRows;
  // this split's vocab tiles [t0, t0 + nt): balanced, none empty (the
  // launcher takes no more splits than tiles)
  const int all = (V + kFwdCols - 1) / kFwdCols;
  const int t0 = blockIdx.y * all / gridDim.y;
  const int nt = (blockIdx.y + 1) * all / gridDim.y - t0;
  const int nb = (D + 63) / 64;            // 64-column boxes of D
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {                 // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int i = 0; i < nt * nb; ++i) {
        const int st = i % kFwdStages;
        // the stage's previous boxes released by all eight consumer warps
        if (i >= kFwdStages)
          bar_wait(ring.empty(st), (i / kFwdStages - 1) & 1);
        const uint32_t dst = ring.base + st * kFwdStage;
        const int d0 = 64 * (i % nb);
        bar_expect(ring.full(st), kFwdStage);
        tma_load_2d(dst, &hm, ring.full(st), d0, r0);
        tma_load_2d(dst + kHBox, &wm, ring.full(st), d0,
                    (t0 + i / nb) * kFwdCols);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kConsumerRegs>();

  const int wg = tid / 128, l = tid % 32;
  const int row = r0 + 64 * wg + 16 * ((tid / 32) % 4) + l / 4;  // and +8
  int tcol[2];                             // the target column, or -1
  float m[2], ls[2], tl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h < N ? tgt[row + 8 * h] - 1 : -1;
    tcol[h] = t >= 0 && t < V ? t : -1;
    m[h] = -INFINITY;
    ls[h] = tl[h] = 0.f;
  }
  // released by a warp once the products that read the stage are done
  auto release = [&](int i) {
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(i % kFwdStages));
  };

  float acc[128];
  zero(acc);
  keep(acc);
  for (int t = 0, i = 0; t < nt; ++t) {
    const int v0 = (t0 + t) * kFwdCols, c0 = v0 + 2 * (l % 4);
    float2 bias[32];
    load_bias(bias, b, V, v0, c0);
    for (int kb = 0; kb < nb; ++kb, ++i) {
      const int st = i % kFwdStages;
      const uint32_t hs = ring.base + st * kFwdStage, ws = hs + kHBox;
      warp_wait(ring.full(st), (i / kFwdStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n256(acc, desc_k<kFwdRows>(hs, 64 * wg, kk),
                      desc_k<kFwdCols>(ws, 0, kk), kb > 0 || kk > 0);
      wg_commit();
      if (kb > 0) {
        wg_wait<1>();                      // the previous box's products
        release(i - 1);
      }
    }
    wg_wait();
    keep(acc);
    release(i - 1);
    fold(acc, bias, c0, tcol, m, ls, tl);
  }

  // this split's (max, sum of exp, target logit) of the two rows
  const int64_t plane = static_cast<int64_t>(gridDim.y) * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = group_sum<4>(ls[h]), t = group_sum<4>(tl[h]);
    const int r = row + 8 * h;
    if (l % 4 == 0 && r < N) {
      const int64_t at = static_cast<int64_t>(blockIdx.y) * N + r;
      part[at] = m[h];
      part[plane + at] = sum;
      part[2 * plane + at] = t;
    }
  }
}

// the vocab walks of the dh kernel (walk_splits): N / 128 clusters of a
// whole walk (64 at N 8192, 30 at once on an H100 SXM) take 4
int dh_splits(int N, int V) {
  static const int clusters = max_clusters(fce_bwd_tc_kernel<false>, kRanks,
                                           true, kThreads, kSmem);
  return walk_splits((N + kRows - 1) / kRows, (V + kX - 1) / kX, clusters);
}

template <bool kVocabRows>
int bwd(const void* h, const void* w, const float* b, const int* t,
        const float* lse, const float* g, void* out, float* part, float* db,
        int N, int V, int D, int splits, cudaStream_t st) {
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;
  CUtensorMap rm, xm;
  if (int e = make_map(&rm, kVocabRows ? w : h, nR, D, kRows)) return e;
  if (int e = make_map(&xm, kVocabRows ? h : w, nX, D, kX)) return e;
  auto kernel = fce_bwd_tc_kernel<kVocabRows>;
  if (int e = set_smem(kernel, kSmem)) return e;
  kernel<<<dim3((nR + kRows - 1) / kRows, kRanks, splits), kThreads, kSmem,
           st>>>(rm, xm, b, t, lse, g, static_cast<bf16*>(out), part, db, N,
                 V, D);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  return splits > 1 ? dh_merge(part, splits, static_cast<int64_t>(nR) * D,
                               static_cast<bf16*>(out), st)
                    : 0;
}

int fwd_splits(int N, int V, int sms) {
  return vocab_splits(N, V, kFwdRows, kFwdCols, sms);
}

int fwd(const void* h, const void* w, const float* b, const int* t,
        float* part, float* nll, float* lse, int N, int V, int D,
        int splits, cudaStream_t st) {
  CUtensorMap hm, wm;
  if (int e = make_map(&hm, h, N, D, kFwdRows)) return e;
  if (int e = make_map(&wm, w, V, D, kFwdCols)) return e;
  if (int e = set_smem(fce_fwd_tc_kernel, FwdLayout::kSmem)) return e;
  fce_fwd_tc_kernel<<<dim3((N + kFwdRows - 1) / kFwdRows, splits),
                      kFwdThreads, FwdLayout::kSmem, st>>>(hm, wm, b, t,
                                                           part, N, V, D);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  return merge(part, splits, N, nll, lse, st);
}

// ---------------------------------------------------------------------------
// backward past D 1024: dl of a chunk of resident rows (pass 1), then the
// chunk's dl · X (pass 2)
// ---------------------------------------------------------------------------

// the workspace's bytes: one chunk of resident rows' bf16 dl, and dW's db
// partials
constexpr int64_t kChunkBytes = 128ll << 20;
constexpr int kColWords = 3 * kFwdCols;    // a tile's column values
// pass 1's shared memory (from the 1024-aligned base): the forward's ring,
// two slots of column values, then the ring's barriers (Ring) and
// colfull[2], colempty[2]
constexpr int kDlCols = kFwdStages * kFwdStage;
constexpr int kDlBars = kDlCols + 2 * kColWords * 4;
constexpr int kDlColBars = kDlBars + 8 * (2 * kFwdStages + 1);
constexpr size_t kDlSmem = 1024 + kDlColBars + 8 * 4;
static_assert(kDlSmem <= 232448, "more shared memory than a CTA may have");

// Pass 1. dl of the chunk's resident rows [r0, r0 + rows) (this CTA's
// 128 from r0 + 128·blockIdx.x) against the walked tiles of 256 columns
// of split blockIdx.y (balanced, none empty), into `dl` (rows x nXp bf16,
// row-major; columns past nX are not written: pass 2's map stops at nX).
// The forward's products; the producer warpgroup's first thread streams
// the ring, its second warp the tiles' column values. dW (kVocabRows)
// writes each vocab row's unrounded dl summed over a tile to dbp[tile][row].
template <bool kVocabRows>
__global__ void __launch_bounds__(kFwdThreads, 1)
fce_dl_tc_kernel(const __grid_constant__ CUtensorMap rm,
                 const __grid_constant__ CUtensorMap xm,
                 const float* __restrict__ b, const int* __restrict__ tgt,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 bf16* __restrict__ dl, float* __restrict__ dbp, int r0,
                 int rows, int nR, int nX, int nXp, int D) {
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  // colfull[s] takes the column warp's 32 arrivals, colempty[s] one from
  // each consumer warp
  const uint32_t cbar = ((smem_u32(smem_raw) + 1023) & ~1023u) + kDlColBars;
  if (threadIdx.x == 0)
    for (int s = 0; s < 2; ++s) {
      bar_init(cbar + 8 * s, 32);
      bar_init(cbar + 16 + 8 * s, kConsumers / 32);
    }
  const Ring<kFwdStages> ring =
      make_ring<kFwdStages>(smem_raw, kDlBars, kConsumers / 32);
  float* const cols = reinterpret_cast<float*>(
      smem_raw + (ring.base - smem_u32(smem_raw)) + kDlCols);
  const int rt = r0 + blockIdx.x * kFwdRows;
  const int all = (nX + kFwdCols - 1) / kFwdCols;
  const int t0 = blockIdx.y * all / gridDim.y;
  const int nt = (blockIdx.y + 1) * all / gridDim.y - t0;
  const int nb = (D + 63) / 64;            // 64-column boxes of D
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {                 // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int i = 0; i < nt * nb; ++i) {
        const int st = i % kFwdStages;
        if (i >= kFwdStages)
          bar_wait(ring.empty(st), (i / kFwdStages - 1) & 1);
        const uint32_t dst = ring.base + st * kFwdStage;
        const int d0 = 64 * (i % nb);
        bar_expect(ring.full(st), kFwdStage);
        tma_load_2d(dst, &rm, ring.full(st), d0, rt);
        tma_load_2d(dst + kHBox, &xm, ring.full(st), d0,
                    (t0 + i / nb) * kFwdCols);
      }
    } else if (tid / 32 == kConsumers / 32 + 1) {   // the column warp
      for (int t = 0; t < nt; ++t) {
        const int s = t & 1;
        if (t >= 2) bar_wait(cbar + 16 + 8 * s, ((t >> 1) - 1) & 1);
        float* const c = cols + s * kColWords;
        for (int k = tid % 32; k < kFwdCols; k += 32) {
          const int x = (t0 + t) * kFwdCols + k;
          const bool ok = x < nX;
          if (kVocabRows) {
            c[k] = ok ? lse[x] * kLog2e : 0.f;
            c[kFwdCols + k] = ok ? g[x] : 0.f;
            reinterpret_cast<int*>(c)[2 * kFwdCols + k] = ok ? tgt[x] - 1
                                                              : -1;
          } else {
            c[k] = ok ? b[x] : 0.f;
          }
        }
        bar_arrive(cbar + 8 * s);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kConsumerRegs>();

  const int wg = tid / 128, l = tid % 32;
  // this thread's rows of the CTA's 128: lr and lr + 8
  const int lr = 64 * wg + 16 * ((tid / 32) % 4) + l / 4;
  // dh: the token's lse·log2 e, g and target column; dW: the vocab
  // entry's bias. Rows past the chunk store nothing.
  float rv[2], rg[2];
  int rcol[2];
  bool rok[2];
  bf16* rdl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt + lr + 8 * h;
    rok[h] = r - r0 < rows;
    rv[h] = !rok[h] ? 0.f : kVocabRows ? b[r] : lse[r] * kLog2e;
    rg[h] = !kVocabRows && rok[h] ? g[r] : 0.f;
    rcol[h] = !kVocabRows && rok[h] ? tgt[r] - 1 : -1;
    rdl[h] = dl + static_cast<int64_t>(r - r0) * nXp;
  }
  auto release = [&](int i) {
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(i % kFwdStages));
  };

  float acc[128];
  zero(acc);
  keep(acc);
  for (int t = 0, i = 0; t < nt; ++t) {
    for (int kb = 0; kb < nb; ++kb, ++i) {
      const int st = i % kFwdStages;
      const uint32_t rs = ring.base + st * kFwdStage, xs = rs + kHBox;
      warp_wait(ring.full(st), (i / kFwdStages) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n256(acc, desc_k<kFwdRows>(rs, 64 * wg, kk),
                      desc_k<kFwdCols>(xs, 0, kk), kb > 0 || kk > 0);
      wg_commit();
      if (kb > 0) {
        wg_wait<1>();                      // the previous box's products
        release(i - 1);
      }
    }
    wg_wait();
    keep(acc);
    release(i - 1);

    const int s = t & 1;
    warp_wait(cbar + 8 * s, (t >> 1) & 1);
    const float* const c = cols + s * kColWords;
    const int x0 = (t0 + t) * kFwdCols;
    float dbs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kFwdCols / 8; ++j) {
      const int cl = 8 * j + 2 * (l % 4), x = x0 + cl;
      float2 cv = *reinterpret_cast<const float2*>(c + cl);
      float2 cg = make_float2(0.f, 0.f);
      int2 ct = make_int2(-1, -1);
      if (kVocabRows) {
        cg = *reinterpret_cast<const float2*>(c + kFwdCols + cl);
        ct = *reinterpret_cast<const int2*>(c + 2 * kFwdCols + cl);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rt + lr + 8 * h;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = acc[4 * j + 2 * h + e];
          const float cvv = e ? cv.y : cv.x;
          d[e] = kVocabRows
                     ? (ex2(fmaf(sv + rv[h], kLog2e, -cvv)) -
                        ((e ? ct.y : ct.x) == r ? 1.f : 0.f)) *
                           (e ? cg.y : cg.x)
                     : (ex2(fmaf(sv + cvv, kLog2e, -rv[h])) -
                        (x + e == rcol[h] ? 1.f : 0.f)) * rg[h];
          if (x + e >= nX) d[e] = 0.f;
          dbs[h] += d[e];
        }
        if (rok[h] && x < nX)
          *reinterpret_cast<uint32_t*>(rdl[h] + x) = pack_bf16(d[0], d[1]);
      }
    }
    __syncwarp();
    if (l == 0) bar_arrive(cbar + 16 + 8 * s);
    if (kVocabRows) {                      // the rows' db over this tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = quad_sum(dbs[h]);
        if (l % 4 == 0 && rok[h])
          dbp[static_cast<int64_t>(t0 + t) * nR + rt + lr + 8 * h] = sum;
      }
    }
  }
}

// Pass 2. out rows [128·blockIdx.y, +128) of the chunk, columns [256·
// blockIdx.x, +256): the chunk's dl (A, rows x nX from the map am: [128]
// [64] K-major boxes) times X (B, nX x D from bm: [64][64] boxes, read
// MN-major), K the whole walk in 64-row steps through the forward's ring;
// the f32 sums rounded to bf16 once. X boxes wholly past D are not
// loaded: the stale columns they leave feed only outputs past D.
__global__ void __launch_bounds__(kFwdThreads, 1)
fce_gemm_tc_kernel(const __grid_constant__ CUtensorMap am,
                   const __grid_constant__ CUtensorMap bm,
                   bf16* __restrict__ out, int rows, int nX, int D) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<kFwdStages> ring =
      make_ring<kFwdStages>(smem_raw, FwdLayout::kBars, kConsumers / 32);
  const int r0 = blockIdx.y * kFwdRows, d0 = blockIdx.x * kFwdCols;
  const int nk = (nX + 63) / 64;           // K steps of 64 walked rows
  const int nc = min(kFwdCols / 64, (D - d0 + 63) / 64);
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {                 // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kFwdStages;
        if (i >= kFwdStages)
          bar_wait(ring.empty(st), (i / kFwdStages - 1) & 1);
        const uint32_t dst = ring.base + st * kFwdStage;
        bar_expect(ring.full(st), kHBox + nc * 64 * kRowBytes);
        tma_load_2d(dst, &am, ring.full(st), 64 * i, r0);
        for (int c = 0; c < nc; ++c)
          tma_load_2d(dst + kHBox + c * 64 * kRowBytes, &bm, ring.full(st),
                      d0 + 64 * c, 64 * i);
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kConsumerRegs>();

  const int wg = tid / 128, l = tid % 32;
  auto release = [&](int i) {
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(i % kFwdStages));
  };
  float acc[128];
  zero(acc);
  keep(acc);
  for (int i = 0; i < nk; ++i) {
    const int st = i % kFwdStages;
    const uint32_t as = ring.base + st * kFwdStage, bs = as + kHBox;
    warp_wait(ring.full(st), (i / kFwdStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n256<1>(acc, desc_k<kFwdRows>(as, 64 * wg, kk),
                       desc_mn_wide<64>(bs, kk), i > 0 || kk > 0);
    wg_commit();
    if (i > 0) {
      wg_wait<1>();                        // the previous step's products
      release(i - 1);
    }
  }
  wg_wait();
  keep(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 64 * wg + 16 * ((tid / 32) % 4) + l / 4 + 8 * h;
    if (r >= rows) continue;
    bf16* const o = out + static_cast<int64_t>(r) * D + d0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * (l % 4);
      if (d0 + c < D)                      // D a multiple of 8: c + 1 too
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// db[v] = the walked tiles' partial sums of row v (`tiles` planes of n),
// added in tile order
__global__ void fce_db_merge_kernel(const float* __restrict__ part,
                                    int tiles, int n, float* __restrict__ db) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  float s = 0.f;
  for (int z = 0; z < tiles; ++z) s += part[static_cast<int64_t>(z) * n + v];
  db[v] = s;
}

// the resident rows of a chunk: the most 128-row tiles whose bf16 dl (a
// row of nX rounded up to 8) fits kChunkBytes beside `fixed` bytes (dW's
// db partials), at least one, no more than nR needs
inline int chunk_rows(int nR, int nX, int64_t fixed) {
  const int64_t row = static_cast<int64_t>((nX + 7) / 8 * 8) * 2;
  const int64_t tiles = (kChunkBytes - fixed) / row / kFwdRows;
  const int fit = static_cast<int>(tiles > 1 ? tiles : 1) * kFwdRows;
  const int need = (nR + kFwdRows - 1) / kFwdRows * kFwdRows;
  return fit < need ? fit : need;
}

// dh (kVocabRows false) or dW and db (true) past D 1024: for each chunk of
// chunk_rows resident rows, pass 1 writes its dl into `work` (rows x nXp
// bf16; dW's db partials follow the chunk, walked tiles x nR f32), pass 2
// its rows of out; dW then merges db
template <bool kVocabRows>
int chunked(const void* h, const void* w, const float* b, const int* t,
            const float* lse, const float* g, void* out, float* db, int N,
            int V, int D, cudaStream_t st, float* work) {
  if (!work) return -1;
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;
  const void* const X = kVocabRows ? h : w;
  const int tiles = (nX + kFwdCols - 1) / kFwdCols;
  const int64_t parts = kVocabRows ? static_cast<int64_t>(tiles) * nR : 0;
  const int nXp = (nX + 7) / 8 * 8, rc = chunk_rows(nR, nX, 4 * parts);
  bf16* const dl = reinterpret_cast<bf16*>(work);
  float* const dbp = work + static_cast<int64_t>(rc) * nXp / 2;
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(e);
  CUtensorMap rm, xm, bm;
  if (int e = make_map(&rm, kVocabRows ? w : h, nR, D, kFwdRows)) return e;
  if (int e = make_map(&xm, X, nX, D, kFwdCols)) return e;
  if (int e = make_map(&bm, X, nX, D, 64)) return e;
  auto pass1 = fce_dl_tc_kernel<kVocabRows>;
  if (int e = set_smem(pass1, kDlSmem)) return e;
  if (int e = set_smem(fce_gemm_tc_kernel, FwdLayout::kSmem)) return e;
  for (int r0 = 0; r0 < nR; r0 += rc) {
    const int rows = min(rc, nR - r0);
    const int rtiles = (rows + kFwdRows - 1) / kFwdRows;
    CUtensorMap am;
    if (int e = make_map(&am, dl, rows, nX, kFwdRows, false, nXp)) return e;
    pass1<<<dim3(rtiles, vocab_splits(rows, nX, kFwdRows, kFwdCols, sms)),
            kFwdThreads, kDlSmem, st>>>(rm, xm, b, t, lse, g, dl, dbp, r0,
                                        rows, nR, nX, nXp, D);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
    fce_gemm_tc_kernel<<<dim3((D + kFwdCols - 1) / kFwdCols, rtiles),
                         kFwdThreads, FwdLayout::kSmem, st>>>(
        am, bm, static_cast<bf16*>(out) + static_cast<int64_t>(r0) * D, rows,
        nX, D);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
  }
  if (!kVocabRows) return 0;
  fce_db_merge_kernel<<<(nR + 255) / 256, 256, 0, st>>>(dbp, tiles, nR,
                                                          db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ===========================================================================
// f32 dh and dW/db: 3xTF32 on the tensor cores, clusters of two CTAs
// ===========================================================================

namespace tf {

using namespace hopper;

constexpr int kRanks = 2;             // CTAs of a cluster
constexpr int kStages = 3;            // ring stages (of kTfStage bytes)
// output chunks (64 columns) a cluster owns: kTfMaxOwn a warpgroup
constexpr int kSliceChunks = kRanks * 2 * kTfMaxOwn;
constexpr int kTile = 64 * 64 * 4;    // one 64 x 64 f32 tile: 16 KB
constexpr int kColBytes = 3 * 64 * 4;

// shared memory (bytes from the 1024-aligned base): the ring of ns
// stages; dl's tf32 parts (hi, then lo, two [64][32] tiles each);
// warpgroup 1's half of the CTA's partial logits; the partner CTA's
// partial logits, in two buffers (tile i in buffer i % 2); the walked
// tile's column values (dh: the bias; dW: each token's lse, g and target
// column); then the barriers full[kTfMaxStages], empty[kTfMaxStages],
// xfull[2], xempty[2]
__host__ __device__ constexpr int bars_at(int ns) {
  return ns * kTfStage + 4 * kTfBox + 3 * kTile + kColBytes;
}
__host__ __device__ constexpr size_t smem_bytes(int ns) {
  return 1024 + bars_at(ns) + 8 * (2 * kTfMaxStages + 4);
}
static_assert(smem_bytes(kStages) <= 232448,
              "more shared memory than a CTA may have");

// The cluster's logits tile from its CTAs' partials (warpgroup 0; tile
// i of the walk): this CTA's s (a 64 x 64 accumulator) goes into the
// partner's buffer i % 2 in tf_give's layout, and the partner's, from
// this CTA's own buffer, is added to s (tf_take): s0 + s1 in both CTAs,
// the same f32 sums. xfull[b] completes when the partner's 128 threads
// have put a tile in buffer b; xempty[b] when they have read the tile
// this CTA put in theirs, which tile i + 2 waits for.
__device__ __forceinline__ void exchange(float (&s)[32], uint32_t recv,
                                         uint32_t xfull, uint32_t xempty,
                                         int rank, int i) {
  const int b = i % 2, t = threadIdx.x % 128;
  const uint32_t buf = recv + b * kTile;
  if (i >= 2) bar_wait_cluster(xempty + 8 * b, ((i - 2) / 2) & 1);
  const uint32_t there = mapa(buf, rank ^ 1);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    st_cluster4(there + 16 * (128 * q + t), s[4 * q], s[4 * q + 1],
                s[4 * q + 2], s[4 * q + 3]);
  bar_arrive_remote(mapa(xfull + 8 * b, rank ^ 1));
  bar_wait_cluster(xfull + 8 * b, (i / 2) & 1);
  tf_take(s, buf);
  bar_arrive_remote(mapa(xempty + 8 * b, rank ^ 1));
}
// before warpgroup 0 leaves: the partner has read the tiles this CTA put
// in its buffers last, so none of its arrivals lands after this CTA exits
__device__ __forceinline__ void drain(uint32_t xempty, int nxt) {
  for (int i = max(0, nxt - 2); i < nxt; ++i)
    bar_wait_cluster(xempty + 8 * (i % 2), (i / 2) & 1);
}

// a consumer warpgroup's role, as a type: warpgroup 1 or not
template <bool W1>
struct Wg {
  static constexpr bool kW1 = W1;
};

// dh (kVocabRows false: resident rows R = h's token rows, walked X = W's
// vocab rows) or dW and db (true: R = W's rows, X = h's). CTA = 64
// resident rows (blockIdx.y) and `own` output chunks (64 columns of D)
// from chunk own·blockIdx.x; blockIdx.z a part of the walk (dh's splits:
// f32 partial sums into out at split z, merged after). The cluster's two
// CTAs (blockIdx.x 2q, 2q + 1) share the resident rows and split the
// logits' sum over D: each of the four consumer warpgroups sums nh score
// steps of 32 columns. Per walked tile of 64 X rows the ring brings nh
// score steps (R's box raw for each warpgroup and X's parts, six [64][32]
// boxes) and own0 = ceil(own / 2) output steps (X's raw columns of each
// warpgroup's chunk p, two boxes each); warpgroup 1 hands its half of
// the CTA's partial to warpgroup 0 (named barrier 1), which pushes the
// CTA's partial into the partner's buffer, adds the partner's from its
// own (the same f32 sum in both CTAs), forms dl in f32 and puts its tf32
// parts in shared memory (barrier 2); both add Xᵀ·dl to their chunks of
// the output's transpose (tf_out_step), A X's raw columns, B dl's parts.
// db sums the unrounded dl of each row (warpgroup 0 of CTA rank 0).
template <bool kVocabRows>
__global__ void __cluster_dims__(kRanks, 1, 1)
__launch_bounds__(kTfThreads, 1)
fce_bwd_tf32_kernel(const __grid_constant__ CUtensorMap rm,
                    const __grid_constant__ CUtensorMap xm,
                    const __grid_constant__ CUtensorMap xhm,
                    const __grid_constant__ CUtensorMap xlm,
                    const float* __restrict__ b, const int* __restrict__ tgt,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ out,
                    float* __restrict__ db, int N, int V, int D, int own,
                    int ns) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t xb = base + ns * kTfStage;      // dl's parts
  const uint32_t xs = xb + 4 * kTfBox;           // warpgroup 1's half
  const uint32_t recv = xs + kTile;              // the partner's partials
  const uint32_t cols = recv + 2 * kTile;        // the tile's columns
  TfRing ring{base, base + bars_at(ns), ns};
  const uint32_t xfull = ring.bars + 16 * kTfMaxStages, xempty = xfull + 16;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(ring.bars + 8 * s, 1);
      bar_init(ring.bars + 8 * (kTfMaxStages + s), kTfConsumers / 32);
    }
    // the partner's 128 warpgroup-0 threads arrive on each
    for (int i = 0; i < 2; ++i) {
      bar_init(xfull + 8 * i, 128);
      bar_init(xempty + 8 * i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both CTAs' barriers are set up before either arrives on the other's
  cluster_arrive();
  cluster_wait();

  const int rank = cluster_rank();
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;
  const int r0 = blockIdx.y * kTfRows;
  // this walk's X tiles [t0, t0 + nxt): part z of gridDim.z (balanced,
  // none empty: the launcher takes no more parts than tiles)
  const int all = (nX + kTfRows - 1) / kTfRows;
  const int t0 = blockIdx.z * all / gridDim.z;
  const int nxt = (blockIdx.z + 1) * all / gridDim.z - t0;
  // score steps a warpgroup sums (steps past D read TMA's zeros); this
  // CTA's first: the cluster's four warpgroups take D's steps in turn
  const int nh = ((D + 31) / 32 + 2 * kRanks - 1) / (2 * kRanks);
  const int sc0 = 2 * nh * rank;
  // output chunks: warpgroup 0 the CTA's first own0, warpgroup 1 the rest
  const int own0 = (own + 1) / 2, own1 = own - own0;
  const int ch0 = own * blockIdx.x;

  if (tid >= kTfConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kTfConsumers) {
      int t = 0;
      for (int i = 0; i < nxt; ++i) {
        const int x0 = (t0 + i) * kTfRows;
        for (int j = 0; j < nh; ++j, ++t, ring.next()) {
          const uint32_t dst = ring.acquire(t, kTfStage);
          for (int w = 0; w < 2; ++w) {
            const int c = 32 * (sc0 + nh * w + j);
            tma_load_2d(dst + 2 * w * kTfBox, &rm, ring.full(), c, r0);
            tma_load_2d(dst + (2 * w + 1) * kTfBox, &xhm, ring.full(), c,
                        x0);
            tma_load_2d(dst + (4 + w) * kTfBox, &xlm, ring.full(), c, x0);
          }
        }
        for (int p = 0; p < own0; ++p, ++t, ring.next()) {
          const bool two = p < own1;
          const uint32_t dst = ring.acquire(t, (two ? 4 : 2) * kTfBox);
          for (int w = 0; w < (two ? 2 : 1); ++w)
            for (int e = 0; e < 2; ++e)
              tma_load_2d(dst + (2 * w + e) * kTfBox, &xm, ring.full(),
                          64 * (ch0 + own0 * w + p) + 32 * e, x0);
        }
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  const int l = tid % 32;
  const int m = 16 * ((tid / 32) % 4) + l / 4;   // accumulator row
  auto consume = [&](auto role) {
    constexpr int G = decltype(role)::kW1 ? 1 : 0;
    const int mine = G ? own1 : own0;
    float acc[kTfMaxOwn][32], s[32];
#pragma unroll
    for (int j = 0; j < kTfMaxOwn; ++j) zero(acc[j]);
    zero(s);
    // warpgroup 0: its two resident rows' values (dh: the token's lse, g
    // and target column; dW: the vocab row's bias) and db's sums
    bool rok[2];
    float rv[2], rg[2], dbs[2] = {0.f, 0.f};
    int rt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + m + 8 * h;
      rok[h] = G == 0 && row < nR;
      rv[h] = !rok[h] ? 0.f : kVocabRows ? b[row] : lse[row];
      rg[h] = !kVocabRows && rok[h] ? g[row] : 0.f;
      rt[h] = !kVocabRows && rok[h] ? tgt[row] - 1 : -1;
    }
    for (int i = 0; i < nxt; ++i) {
      const int x0 = (t0 + i) * kTfRows;
      // warpgroup 1: thread k loads column k % 64's values for the
      // epilogue now, so the loads run under the score steps
      const int k = tid - 128, x = x0 + k % 64;
      float cv[2] = {0.f, 0.f};
      if (G == 1 && x < nX) {
        if (!kVocabRows) {
          cv[0] = k < 64 ? b[x] : 0.f;
        } else if (k < 64) {
          cv[0] = lse[x];
          cv[1] = __int_as_float(tgt[x] - 1);
        } else {
          cv[0] = g[x];
        }
      }
      for (int j = 0; j < nh; ++j) {
        const uint32_t st = ring.wait();
        tf_score_step(s, st + 2 * G * kTfBox, st + (2 * G + 1) * kTfBox,
                      st + (4 + G) * kTfBox, j == 0);
        ring.release();
      }
      if constexpr (G == 1) {
        tf_give(xs, s);                    // this half of S, the columns'
        st_shared(cols + 4 * k, cv[0]);    // values, then wait for dl
        if (k < 64) st_shared(cols + 4 * (128 + k), cv[1]);
        named_arrive(1, kTfConsumers);
        named_sync(2, kTfConsumers);
      } else {
        named_sync(1, kTfConsumers);
        tf_take(s, xs);                    // the CTA's partial
        exchange(s, recv, xfull, xempty, rank, i);
        // dl = (exp(s + bias - lse) - onehot)·g, 0 past N or V
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 8 * jj + 2 * (l % 4);
          float c0[2], c1[2], c2[2];
          ld_shared2(cols + 4 * c, c0);
          if (kVocabRows) {
            ld_shared2(cols + 4 * (64 + c), c1);
            ld_shared2(cols + 4 * (128 + c), c2);
          }
#pragma unroll
          for (int e = 4 * jj; e < 4 * jj + 4; ++e) {
            const int h = (e % 4) / 2, u = e % 2;
            float d = 0.f;
            if (rok[h] && x0 + c + u < nX)
              d = kVocabRows
                      ? dlogit(s[e] + rv[h], c0[u], c1[u],
                               __float_as_int(c2[u]) == r0 + m + 8 * h)
                      : dlogit(s[e] + c0[u], rv[h], rg[h],
                               x0 + c + u == rt[h]);
            dbs[h] += d;
            s[e] = d;
          }
        }
        tf_put(xb, xb + 2 * kTfBox, s);
        fence_proxy_async();
        named_sync(2, kTfConsumers);
      }
#pragma unroll
      for (int p = 0; p < kTfMaxOwn; ++p) {
        if (p >= own0) break;
        const uint32_t tile = ring.wait() + 2 * G * kTfBox;
        if (p < mine) tf_out_step(acc[p], tile, xb, xb + 2 * kTfBox);
        ring.release();
      }
    }
    if constexpr (G == 0) drain(xempty, nxt);
    // this warpgroup's chunks of the output's transpose: element e of
    // chunk j at column 64·(chw + j) + m + acc_row(e) of resident row r0 +
    // acc_col(e, l) (columns past D and rows past nR not stored)
    const int chw = ch0 + own0 * G;
    float* const dst = out + static_cast<int64_t>(blockIdx.z) * nR * D;
#pragma unroll
    for (int j = 0; j < kTfMaxOwn; ++j) {
      if (j >= mine) break;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + acc_col(e, l);
        const int col = 64 * (chw + j) + m + acc_row(e);
        if (row < nR && col < D)
          dst[static_cast<int64_t>(row) * D + col] = acc[j][e];
      }
    }
    if (kVocabRows && G == 0 && blockIdx.x == 0) {   // slice 0, rank 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // the row's db, over its 4 lanes
        const float sum = quad_sum(dbs[h]);
        if (l % 4 == 0 && rok[h]) db[r0 + m + 8 * h] = sum;
      }
    }
  };
  // the warpgroup index broadcast from lane 0, so the branch is uniform
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 0)
    consume(Wg<false>{});
  else
    consume(Wg<true>{});
}

// the clusters of a row block (slices of at most kSliceChunks 64-column
// chunks, 1024 columns, as many as D needs), and the chunks a CTA owns,
// as even as they come: D 1024 one cluster of 8 + 8, D 1032 two of 5 + 5
inline int slices_of(int D) {
  return ((D + 63) / 64 + kSliceChunks - 1) / kSliceChunks;
}
inline int own_chunks(int D) {
  return ((D + 63) / 64 + kRanks * slices_of(D) - 1) /
         (kRanks * slices_of(D));
}

// the vocab walks of the dh kernel (walk_splits): clusters of 64 token
// rows, (D + 1023) / 1024 of them a row block
int dh_splits(int N, int V, int D) {
  static const int clusters =
      max_clusters(fce_bwd_tf32_kernel<false>, kRanks, false, kTfThreads,
                   smem_bytes(kStages));
  return walk_splits((N + kTfRows - 1) / kTfRows * slices_of(D),
                     (V + kTfRows - 1) / kTfRows, clusters);
}

// the tf32 parts of the n f32 at x into work (hi) and work + n (lo), on
// the current card
int split_pass(const void* x, float* work, int64_t n, cudaStream_t st) {
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (cudaError_t e = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(e);
  return tf_split_pass(x, work, work + n, n, sms, st);
}

// dh (kVocabRows false) or dW and db (true), f32: X's tf32 parts into
// `work` (hi, then lo: 2 x nX x D floats), then the kernel; dh's `splits`
// walks write f32 partial sums to `part` (splits x N x D) and
// fce_dh_merge_kernel adds them into out
template <bool kVocabRows>
int bwd(const void* h, const void* w, const float* b, const int* t,
        const float* lse, const float* g, float* out, float* part,
        float* db, int N, int V, int D, int splits, cudaStream_t st,
        float* work) {
  if (!work) return -1;
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;
  const void* R = kVocabRows ? w : h;
  const void* X = kVocabRows ? h : w;
  const int64_t n = static_cast<int64_t>(nX) * D;
  if (int e = split_pass(X, work, n, st)) return e;
  CUtensorMap rm, xm, xhm, xlm;
  if (int e = make_map(&rm, R, nR, D, kTfRows, true)) return e;
  if (int e = make_map(&xm, X, nX, D, kTfRows, true)) return e;
  if (int e = make_map(&xhm, work, nX, D, kTfRows, true)) return e;
  if (int e = make_map(&xlm, work + n, nX, D, kTfRows, true)) return e;
  constexpr size_t smem = smem_bytes(kStages);
  auto kernel = fce_bwd_tf32_kernel<kVocabRows>;
  if (int e = set_smem(kernel, smem)) return e;
  kernel<<<dim3(kRanks * slices_of(D), (nR + kTfRows - 1) / kTfRows, splits),
           kTfThreads, smem, st>>>(rm, xm, xhm, xlm, b, t, lse, g,
                                   splits > 1 ? part : out, db, N, V, D,
                                   own_chunks(D), kStages);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  return splits > 1
             ? dh_merge(part, splits, static_cast<int64_t>(nR) * D, out, st)
             : 0;
}

// ---------------------------------------------------------------------------
// forward, f32: 3xTF32 products, the bf16 forward's epilogue
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;         // token rows a CTA: 64 a warpgroup
constexpr int kFwdCols = 128;         // vocab columns a tile
constexpr int kFwdStages = 4;         // ring stages
// a stage (tf32.cuh's kTfStage): h's raw box of the CTA's rows, then W's
// tf32 parts hi and lo of the tile's rows, three [128][32] f32 boxes
constexpr int kFwdWHi = 2 * kTfBox, kFwdWLo = 4 * kTfBox;
constexpr int kFwdStage = kTfStage;
// the ring, then tf_init's barriers
constexpr size_t kFwdSmem =
    1024 + kFwdStages * kFwdStage + 8 * (2 * kTfMaxStages + 2);
static_assert(kFwdSmem <= 232448, "more shared memory than a CTA may have");

// One score step of the forward: s += A·Bᵀ over 32 columns of D, A this
// warpgroup's 64 token rows of the stage's raw h box (a_t; warp w rows
// 16w..16w + 15) split into tf32 parts in registers, B the vocab tile's
// 128 rows as W's parts (hi at b_t, lo at blo). The step's products sum
// in one fresh accumulator, the low terms first (hi·lo, lo·hi, four K
// steps of 8 each), then hi·hi, 12 wgmma m64n128k8, and s gains the sum
// in f32: the tensor cores truncate what they add to a running sum
// (tf_score_step), so no sum runs across steps. The caller zeroes s at a
// tile's start, so no step selects between setting and adding.
__device__ __forceinline__ void fwd_score_step(float (&s)[64], uint32_t a_t,
                                               uint32_t b_t, uint32_t blo) {
  const int i = threadIdx.x % 128, l = i % 32;
  const int r0 = 16 * (i / 32) + l / 4, t = l % 4;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(ld_shared(a_t + tf_at(r0 + 8 * (e & 1),
                                       8 * kk + t + 4 * (e >> 1))),
                 ah[kk][e], al[kk][e]);
  float acc[64];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs_n128(acc, ah[kk], desc(blo + 32 * kk), kk > 0);
    wgmma_tf32_rs_n128(acc, al[kk], desc(b_t + 32 * kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32_rs_n128(acc, ah[kk], desc(b_t + 32 * kk), 1);
  wg_commit();
  wg_wait();
  keep(acc);
  keep(ah);
  keep(al);
#pragma unroll
  for (int e = 0; e < 64; ++e) s[e] += acc[e];
}

// The f32 forward. CTA = 128 token rows from kFwdRows·blockIdx.x against
// the vocab tiles of split blockIdx.y (balanced, none empty: the launcher
// takes no more splits than tiles). Per tile of 128 vocab rows the ring
// brings ceil(D / 32) stages, each one score step of both consumer
// warpgroups: h's raw box (TMA reads zeros past N and past D) and W's
// tf32 parts from the split pass (zeros past V and D). A warpgroup sums
// its 64 rows' logits tile over D (fwd_score_step) and folds it into the
// rows' online logsumexp (tc::fold: the bias loaded before the products,
// -inf past V, the target logit, ex2 of one FMA); after the walk (max,
// sum of exp, target logit) of each row go to the split's partials.
__global__ void __launch_bounds__(kTfThreads, 1)
fce_fwd_tf32_kernel(const __grid_constant__ CUtensorMap hm,
                    const __grid_constant__ CUtensorMap whm,
                    const __grid_constant__ CUtensorMap wlm,
                    const float* __restrict__ b, const int* __restrict__ tgt,
                    float* __restrict__ part, int N, int V, int D) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  TfRing ring{base, base + kFwdStages * kFwdStage, kFwdStages};
  tf_init(ring.bars, kFwdStages);
  const int r0 = blockIdx.x * kFwdRows;
  const int all = (V + kFwdCols - 1) / kFwdCols;
  const int t0 = blockIdx.y * all / gridDim.y;
  const int nt = (blockIdx.y + 1) * all / gridDim.y - t0;
  const int nb = (D + 31) / 32;            // score steps of 32 columns
  const int tid = threadIdx.x;

  if (tid >= kTfConsumers) {               // the producer warpgroup
    regs_dec<kTfProducerRegs>();
    if (tid == kTfConsumers) {
      for (int i = 0, t = 0; i < nt; ++i) {
        const int v0 = (t0 + i) * kFwdCols;
        for (int j = 0; j < nb; ++j, ++t, ring.next()) {
          const uint32_t dst = ring.acquire(t, kFwdStage);
          tma_load_2d(dst, &hm, ring.full(), 32 * j, r0);
          tma_load_2d(dst + kFwdWHi, &whm, ring.full(), 32 * j, v0);
          tma_load_2d(dst + kFwdWLo, &wlm, ring.full(), 32 * j, v0);
        }
      }
    }
    return;                                // no CTA barrier after this
  }
  regs_inc<kTfConsumerRegs>();

  // the warpgroup index broadcast from lane 0 (uniform in the warp)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0), l = tid % 32;
  const int row = r0 + 64 * wg + 16 * ((tid / 32) % 4) + l / 4;  // and +8
  int tcol[2];                             // the target column, or -1
  float m[2], ls[2], tl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = row + 8 * h < N ? tgt[row + 8 * h] - 1 : -1;
    tcol[h] = t >= 0 && t < V ? t : -1;
    m[h] = -INFINITY;
    ls[h] = tl[h] = 0.f;
  }
  float s[64];                             // the tile's logits
  for (int t = 0; t < nt; ++t) {
    const int v0 = (t0 + t) * kFwdCols, c0 = v0 + 2 * (l % 4);
    float2 bias[kFwdCols / 8];
    tc::load_bias(bias, b, V, v0, c0);
    zero(s);
    for (int j = 0; j < nb; ++j) {
      const uint32_t st = ring.wait();
      fwd_score_step(s, st + wg * kTfBox, st + kFwdWHi, st + kFwdWLo);
      ring.release();
    }
    tc::fold(s, bias, c0, tcol, m, ls, tl);
  }

  // this split's (max, sum of exp, target logit) of the two rows
  const int64_t plane = static_cast<int64_t>(gridDim.y) * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(ls[h]), t = quad_sum(tl[h]);
    const int r = row + 8 * h;
    if (l % 4 == 0 && r < N) {
      const int64_t at = static_cast<int64_t>(blockIdx.y) * N + r;
      part[at] = m[h];
      part[plane + at] = sum;
      part[2 * plane + at] = t;
    }
  }
}

int fwd_splits(int N, int V, int sms) {
  return vocab_splits(N, V, kFwdRows, kFwdCols, sms);
}

// the f32 forward: W's tf32 parts into `work` (hi, then lo: 2 x V x D
// floats), the kernel into `part` (3 x splits x N floats), then
// fce_merge_kernel
int fwd(const void* h, const void* w, const float* b, const int* t,
        float* part, float* nll, float* lse, int N, int V, int D,
        int splits, cudaStream_t st, float* work) {
  if (!work) return -1;
  const int64_t n = static_cast<int64_t>(V) * D;
  if (int e = split_pass(w, work, n, st)) return e;
  CUtensorMap hm, whm, wlm;
  if (int e = make_map(&hm, h, N, D, kFwdRows, true)) return e;
  if (int e = make_map(&whm, work, V, D, kFwdCols, true)) return e;
  if (int e = make_map(&wlm, work + n, V, D, kFwdCols, true)) return e;
  if (int e = set_smem(fce_fwd_tf32_kernel, kFwdSmem)) return e;
  fce_fwd_tf32_kernel<<<dim3((N + kFwdRows - 1) / kFwdRows, splits),
                        kTfThreads, kFwdSmem, st>>>(hm, whm, wlm, b, t, part,
                                                    N, V, D);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  return merge(part, splits, N, nll, lse, st);
}

}  // namespace tf

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the bf16 backward's cluster kernels take D <= 1024
template <typename T>
constexpr bool clustered(int D) {
  return sizeof(T) == 2 && D <= kClusterD;
}

// the forward: f32 takes the 3xTF32 kernel (its workspace `work`), bf16
// the bf16 tensor-core kernel
template <typename T>
int fwd(const void* h, const void* w, const float* b, const int* t,
        float* part, float* nll, float* lse, int N, int V, int D,
        int splits, cudaStream_t st, float* work) {
  if constexpr (sizeof(T) == 4)
    return tf::fwd(h, w, b, t, part, nll, lse, N, V, D, splits, st, work);
  else
    return tc::fwd(h, w, b, t, part, nll, lse, N, V, D, splits, st);
}

// dh (kVocabRows false: out = dh, db unused; the cluster kernels walk
// `splits` parts of the vocab into `part`, f32 splits x N x D, when
// splits > 1) or dW and db (true: one walk). f32 takes the 3xTF32 kernel
// at every D (its workspace `work`), bf16 the cluster kernel up to D 1024
// and the two chunked passes past it (their workspace `work`).
template <typename T, bool kVocabRows>
int bwd(const void* h, const void* w, const float* b, const int* t,
        const float* lse, const float* g, void* out, float* part, float* db,
        int N, int V, int D, int splits, cudaStream_t st, float* work) {
  if constexpr (sizeof(T) == 4) {
    return tf::bwd<kVocabRows>(h, w, b, t, lse, g, static_cast<float*>(out),
                               part, db, N, V, D, splits, st, work);
  } else {
    if (clustered<T>(D))
      return tc::bwd<kVocabRows>(h, w, b, t, lse, g, out, part, db, N, V, D,
                                 splits, st);
    return tc::chunked<kVocabRows>(h, w, b, t, lse, g, out, db, N, V, D, st,
                                   work);
  }
}

// dispatch on the dtype code: 0 = float32, 1 = bfloat16
#define BIGDL_FCE_DISPATCH(FN, ...)                                   \
  do {                                                                 \
    if (D <= 0 || D % 8 != 0) return -1;                               \
    if (dtype == 0) return FN<float>(__VA_ARGS__);                     \
    if (dtype == 1) return FN<bf16>(__VA_ARGS__);                      \
    return -1;                                                         \
  } while (0)

template <typename T>
int dh(const void* h, const void* w, const float* b, const int* t,
       const float* lse, const float* g, void* out, float* part, int N,
       int V, int D, int splits, cudaStream_t st, float* work) {
  return bwd<T, false>(h, w, b, t, lse, g, out, part, nullptr, N, V, D,
                       splits, st, work);
}

template <typename T>
int dw(const void* h, const void* w, const float* b, const int* t,
       const float* lse, const float* g, void* out, float* db, int N, int V,
       int D, cudaStream_t st, float* work) {
  return bwd<T, true>(h, w, b, t, lse, g, out, nullptr, db, N, V, D, 1, st,
                      work);
}

}  // namespace

// Each entry returns 0 on a clean launch, -1 for a dtype or feature
// width the kernels were not built for (or a call given no workspace
// that needs one), -2 where no tensor-map encoder is found, 1000 + the
// CUresult of a refused tensor map, else the CUDA error code. `part`
// holds 3 x splits x N floats, splits from bigdl_fce_fwd_splits. f32
// needs `work`, 2 x V x D floats (W's tf32 parts); it comes last, after
// the stream.
extern "C" int bigdl_fce_fwd(int dtype, const void* h, const void* w,
                             const float* b, const int* t, float* part,
                             float* nll, float* lse, int N, int V, int D,
                             int splits, void* stream, float* work) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FCE_DISPATCH(fwd, h, w, b, t, part, nll, lse, N, V, D, splits, st,
                     work);
}

// how many parts the forward splits the vocab into on a card of `sms`
// SMs
extern "C" int bigdl_fce_fwd_splits(int dtype, int N, int V, int D,
                                    int sms) {
  return dtype == 1 ? tc::fwd_splits(N, V, sms) : tf::fwd_splits(N, V, sms);
}

// `part` holds splits x N x D floats when splits > 1 (else unused),
// splits from bigdl_fce_dh_splits. f32 needs `work`, 2 x V x D floats
// (W's tf32 parts), bf16 past D 1024 one dl chunk (chunk_rows(N, V, 0) x
// V rounded up to 8, bf16); it comes last, after the stream.
extern "C" int bigdl_fce_dh(int dtype, const void* h, const void* w,
                            const float* b, const int* t, const float* lse,
                            const float* g, void* dh_out, float* part, int N,
                            int V, int D, int splits, void* stream,
                            float* work) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FCE_DISPATCH(dh, h, w, b, t, lse, g, dh_out, part, N, V, D, splits,
                     st, work);
}

// how many parts the dh kernel splits the vocab into (1 for the bf16
// chunked passes past D 1024)
extern "C" int bigdl_fce_dh_splits(int dtype, int N, int V, int D) {
  if (dtype == 0) return tf::dh_splits(N, V, D);
  return dtype == 1 && clustered<bf16>(D) ? tc::dh_splits(N, V) : 1;
}

// f32 needs `work`, 2 x N x D floats (h's tf32 parts), bf16 past D 1024
// one dl chunk (chunk_rows(V, N, db partials' bytes) x N rounded up to 8,
// bf16) and the db partials (ceil(N / 256) x V floats); it comes after
// the stream
extern "C" int bigdl_fce_dw(int dtype, const void* h, const void* w,
                            const float* b, const int* t, const float* lse,
                            const float* g, void* dw_out, float* db, int N,
                            int V, int D, void* stream, float* work) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FCE_DISPATCH(dw, h, w, b, t, lse, g, dw_out, db, N, V, D, st, work);
}

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
// Every kernel walks "resident" rows R against tiles of 64 "streamed"
// rows X: the forward and dh take R = token rows, X = vocab tiles; dW
// takes R = vocab rows, X = token tiles. For each X tile it forms the
// logits tile S = R·Xᵀ over the whole feature axis D, then either folds
// S into an online logsumexp (forward) or turns it into dlogits and adds
// dl·X into a D-wide accumulator (dh, dW). The TPU grid carries that
// state across its sequential axis in VMEM scratch; here the axis is a
// loop inside the CTA and the state lives in registers. The D-wide
// accumulator — the TPU's (512, D) and (1024, D) f32 VMEM tiles — is
// what does not fit: an SM has 256 KB of registers.
//
// bf16 with D <= 1024 (the LM head's path): thread-block clusters.
// Four CTAs on four SMs share 64 resident rows; CTA q of the cluster
// owns feature columns [256q, 256q + 256). It keeps its slice of the 64
// R rows in shared memory for the whole walk and stages only its slice
// of each X tile (cp.async, double buffered), so an X element crosses
// L2 once per cluster. Per tile: each CTA forms the partial S of its
// slice with warp-level tensor-core products (mma.sync m16n8k16, bf16 in,
// f32 accumulate; ldmatrix operands); a cluster barrier; then every CTA
// reads the four partials through distributed shared memory and sums
// them in one fixed order. CTA q takes rows [16q, 16q + 16) of the tile:
// the forward folds them into the online logsumexp; the backward turns
// them into dlogits, rounded to bf16, and writes them into all four
// CTAs' copies of the (64 x 64) dlogits tile; after a second cluster
// barrier every CTA multiplies the whole tile by the same X slice it
// already holds into its (64 x 256) f32 accumulator (64 registers a
// thread). Nothing is recomputed and no partial sum leaves the cluster.
//
// f32 (and bf16 with D > 1024): f32 arithmetic on the CUDA cores, one
// CTA per 16 resident rows. D is streamed in 64-column chunks of R and X
// (cp.async, double buffered); the 256 threads split a chunk's columns
// into four parts of 64 threads, each owning 4 x 4 register tiles,
// summed through shared memory at the end. The backward's accumulator
// is 16 rows x 1024 columns (thread t: columns 4t .. 4t+3), X's rows
// read back from L2; D beyond 1024 takes more CTAs along a second grid
// axis, each recomputing S.
//
// Both forwards may split the vocab across a further grid axis so that a
// few rows still fill the card; fce_merge_kernel merges the per-split
// (max, sum of exp, target logit) of each row into nll and lse. The
// kernels allocate nothing: the Python wrapper (ops/fused_ce.py)
// allocates outputs and the forward's partials and checks shapes,
// dtypes, contiguity and alignment. Any N, any V, D a multiple of 8
// (16-byte row chunks for cp.async); ragged tiles are zero-filled and
// masked.
//
// Bound on the H100: at the harness shapes (N 8192, V 32768, D 1024,
// bf16) the forward does 2·N·V·D = 5.5e11 operations on 85 MB of inputs
// and each backward kernel twice that, thousands of operations a byte,
// far above the ~295 at which the tensor cores bind: all three are bound
// by operations (0.56 / 1.1 / 1.1 ms at 989 TFLOP/s). mma.sync reaches a
// fraction of that rate; wgmma fed by TMA is the next step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kX = 64;        // streamed rows per tile (both paths)

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
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

// x as a product operand of dtype T sees it
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, bf16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// Stage `rows` rows from `row0` (valid below n) and `cols` feature
// columns from d0 (valid below D) of x (rows of D) into dst at `pitch`
// elements a row; the rest is zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* x,
                                           int row0, int rows, int n, int D,
                                           int d0, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = cols / kVec;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, w = (i % chunks) * kVec;
    const bool ok = row0 + r < n && d0 + w < D;
    cp_async16(dst + r * pitch + w,
               ok ? x + static_cast<int64_t>(row0 + r) * D + d0 + w : x, ok);
  }
}

// one vocab tile of the online logsumexp: thread t holds s[e] = S[row]
// [4(t%16) + e] of vocab tile xt for its row; the 16 lanes of a row keep
// identical (m, l) and each its share of the target logit
struct OnlineLse {
  const float* b;
  int V, tcol;
  float m, l, tl;
  __device__ void operator()(int xt, float (&s)[4]) {
    const int v0 = xt * kX + (threadIdx.x % 16) * 4;
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = v0 + e;
      if (v < V) {
        s[e] += b[v];
        if (v == tcol) tl += s[e];
      } else {
        s[e] = -INFINITY;                   // past the vocab's end
      }
      mx = fmaxf(mx, s[e]);
    }
    const float m_new = fmaxf(m, group_max<16>(mx));
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += expf(s[e] - m_new);
    l = l * expf(m - m_new) + group_sum<16>(sum);
    m = m_new;
  }
  // this row's (m, l, tl) into the forward's partials
  __device__ void write(float* part, int split, int splits, int N,
                        int row) {
    const float t = group_sum<16>(tl);
    if (threadIdx.x % 16 == 0 && row < N) {
      const int64_t at = static_cast<int64_t>(split) * N + row;
      const int64_t plane = static_cast<int64_t>(splits) * N;
      part[at] = m;
      part[plane + at] = l;
      part[2 * plane + at] = t;
    }
  }
};

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

// dl of logit s at (resident row, streamed column) — which of the two is
// the token depends on the kernel
__device__ __forceinline__ float dlogit(float s, float lse, float g,
                                        bool target) {
  return (expf(s - lse) - (target ? 1.f : 0.f)) * g;
}

// ===========================================================================
// bf16, D <= 1024: thread-block clusters and tensor cores
// ===========================================================================

constexpr int kRanks = 4;             // CTAs of a cluster
constexpr int kCR = 64;               // resident rows per cluster
constexpr int kSlice = 256;           // feature columns per CTA
constexpr int kSP = kSlice + 8;       // pitch (bf16) of R and X slices
constexpr int kPSP = kX + 4;          // pitch (f32) of a partial S tile
constexpr int kGP = kX + 8;           // pitch (bf16) of the dlogits tile
constexpr int kClusterD = kRanks * kSlice;

// shared memory of a cluster CTA (bytes): R slice, two X slices, two
// partial S tiles, the dlogits tile
constexpr size_t kOffX = kCR * kSP * sizeof(bf16);
constexpr size_t kOffPS = kOffX + 2 * kX * kSP * sizeof(bf16);
constexpr size_t kOffG = kOffPS + 2 * kCR * kPSP * sizeof(float);
constexpr size_t kClusterSmem = kOffG + kCR * kGP * sizeof(bf16);

// c += a·b, one m16n8k16 tensor-core product (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory; lane i gives the address
// of row i % 8 of matrix i / 8. Plain: lane t receives row t / 4, columns
// 2(t % 4) .. +1 of each; trans: rows 2(t % 4) .. +1 of column t / 4.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragment (16 rows from `row0`, k16 from `k0`) of a row-major tile
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int pitch, int row0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm4(a, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + k0 +
               (lane >> 4) * 8);
}

// this CTA's partial logits tile: ps (64 x 64 f32) = Rs · Xsᵀ over its
// 256 feature columns. Warp w: rows 16(w % 4) .., columns 32(w / 4) ..
__device__ __forceinline__ void partial_s(float* ps, const bf16* Rs,
                                          const bf16* Xs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mb = (warp % 4) * 16, nb = (warp / 4) * 32;
  float c[4][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < kSlice; k0 += 16) {
    uint32_t a[4];
    a_frag(a, Rs, kSP, mb, k0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {           // two pairs of n8 tiles
      uint32_t b[4];
      ldsm4(b, Xs + (nb + j * 16 + (lane >> 4) * 8 + (lane & 7)) * kSP + k0 +
                   ((lane >> 3) & 1) * 8);
      mma(c[2 * j], a, b[0], b[1]);
      mma(c[2 * j + 1], a, b[2], b[3]);
    }
  }
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float* p = ps + (mb + gid) * kPSP + nb + t * 8 + tig * 2;
    p[0] = c[t][0];
    p[1] = c[t][1];
    p[8 * kPSP] = c[t][2];
    p[8 * kPSP + 1] = c[t][3];
  }
}

// acc (this CTA's 64 x 256 slice of dh or dW) += G (64 x 64 bf16
// dlogits) · Xs (64 x 256). Warp w: rows 16(w % 4) .., columns
// 128(w / 4) .. +128 as 16 m16n8 fragments.
__device__ __forceinline__ void accumulate_tc(float (&acc)[16][4],
                                              const bf16* G, const bf16* Xs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mb = (warp % 4) * 16, nb = (warp / 4) * 128;
#pragma unroll
  for (int k0 = 0; k0 < kX; k0 += 16) {
    uint32_t a[4];
    a_frag(a, G, kGP, mb, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {           // pairs of n8 tiles
      uint32_t b[4];
      ldsm4_t(b, Xs + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kSP + nb +
                     j * 16 + (lane >> 4) * 8);
      mma(acc[2 * j], a, b[0], b[1]);
      mma(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// Walk X tiles [xt0, xt1) against the cluster's 64 resident rows from
// r0: this CTA stages its feature slice, forms its partial S of each tile
// and, after a cluster barrier, calls epi(xt, parts, xs) with the four
// CTAs' partial tiles (parts[q], shared memory of CTA q) and its own X
// slice. Every thread calls epi; it may synchronise the CTA.
template <typename Epi>
__device__ __forceinline__ void cluster_walk(const bf16* __restrict__ R,
                                             int r0, int nR,
                                             const bf16* __restrict__ X,
                                             int nX, int xt0, int xt1, int D,
                                             unsigned char* smem, Epi& epi) {
  cg::cluster_group cluster = cg::this_cluster();
  const int d0 = static_cast<int>(cluster.block_rank()) * kSlice;
  bf16* const Rs = reinterpret_cast<bf16*>(smem);
  bf16* const Xs = reinterpret_cast<bf16*>(smem + kOffX);
  float* const ps = reinterpret_cast<float*>(smem + kOffPS);

  stage_rows<bf16>(Rs, kSP, R, r0, kCR, nR, D, d0, kSlice);
  if (xt0 < xt1) stage_rows<bf16>(Xs, kSP, X, xt0 * kX, kX, nX, D, d0, kSlice);
  cp_async_commit();
  for (int xt = xt0; xt < xt1; ++xt) {
    const int i = xt - xt0;
    const bf16* xs = Xs + (i & 1) * kX * kSP;
    if (xt + 1 < xt1)
      stage_rows<bf16>(Xs + ((i + 1) & 1) * kX * kSP, kSP, X, (xt + 1) * kX,
                       kX, nX, D, d0, kSlice);
    cp_async_commit();
    cp_async_wait_prev();                  // R and this tile's X landed
    __syncthreads();
    // partial tiles are double buffered: a CTA rewrites buffer i & 1
    // only after every CTA passed the barrier of tile i - 1, so after
    // all reads of it at tile i - 2
    float* p = ps + (i & 1) * kCR * kPSP;
    partial_s(p, Rs, xs);
    cluster.sync();                        // the four partials are complete
    const float* parts[kRanks];
#pragma unroll
    for (int q = 0; q < kRanks; ++q) parts[q] = cluster.map_shared_rank(p, q);
    epi(xt, parts, xs);
    __syncthreads();                       // X buffer free for reuse
  }
  cluster.sync();             // no CTA leaves while others read its tiles
}

// S[row][col .. col + n) summed over the cluster's partials, in rank order
template <int n>
__device__ __forceinline__ void full_s(float (&s)[n],
                                       const float* const (&parts)[kRanks],
                                       int row, int col) {
#pragma unroll
  for (int e = 0; e < n; ++e) s[e] = 0.f;
#pragma unroll
  for (int q = 0; q < kRanks; ++q)
#pragma unroll
    for (int e = 0; e < n; e += 4) {
      float x[4];
      load4(parts[q] + row * kPSP + col + e, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) s[e + u] += x[u];
    }
}

// ---------------------------------------------------------------------------
// forward: CTA q takes rows 16q .. 16q + 15 of the cluster's 64
// ---------------------------------------------------------------------------

struct ClusterFwdEpi {
  OnlineLse lse;
  int local_row;
  __device__ void operator()(int xt, const float* const (&parts)[kRanks],
                             const bf16*) {
    float s[4];
    full_s<4>(s, parts, local_row, (threadIdx.x % 16) * 4);
    lse(xt, s);
  }
};

__global__ void __cluster_dims__(1, kRanks, 1) __launch_bounds__(kThreads, 1)
fce_fwd_cluster_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                       const float* __restrict__ b,
                       const int* __restrict__ tgt, float* __restrict__ part,
                       int N, int V, int D, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r0 = blockIdx.x * kCR, split = blockIdx.z;
  const int local_row = blockIdx.y * 16 + threadIdx.x / 16;
  const int row = r0 + local_row;
  const int nvt = (V + kX - 1) / kX;
  const int xt0 = split * tiles_per_split;
  const int xt1 = min(xt0 + tiles_per_split, nvt);
  ClusterFwdEpi epi{{b, V, row < N ? tgt[row] - 1 : -1, -INFINITY, 0.f, 0.f},
                    local_row};
  cluster_walk(h, r0, N, w, V, xt0, xt1, D, smem_raw, epi);
  epi.lse.write(part, split, gridDim.z, N, row);
}

// ---------------------------------------------------------------------------
// backward: CTA q forms rows 16q .. 16q + 15 of the dlogits tile (thread
// t: row 16q + t / 16, columns 4(t % 16) .. +3), writes them rounded into
// every CTA's copy of the tile, and after a second cluster barrier each
// CTA multiplies the whole tile into its slice
// ---------------------------------------------------------------------------

template <bool kVocabRows>
struct ClusterBwdEpi {
  const float *b, *lse, *g;
  const int* tgt;
  bf16* G;
  int r0, nR, nX;
  float db;
  float acc[16][4];
  __device__ void operator()(int xt, const float* const (&parts)[kRanks],
                             const bf16* xs) {
    cg::cluster_group cluster = cg::this_cluster();
    const int r = static_cast<int>(cluster.block_rank()) * 16 +
                  threadIdx.x / 16;
    const int c0 = (threadIdx.x % 16) * 4;
    float s[4];
    full_s<4>(s, parts, r, c0);
    const int rr = r0 + r;
    // dh: the resident row is the token; dW: the vocab entry
    const bool row_ok = rr < nR;
    const float row_lse = !kVocabRows && row_ok ? lse[rr] : 0.f;
    const float row_g = !kVocabRows && row_ok ? g[rr] : 0.f;
    const int row_t = !kVocabRows && row_ok ? tgt[rr] - 1 : -1;
    const float row_b = kVocabRows && row_ok ? b[rr] : 0.f;
    float dl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = xt * kX + c0 + e;
      dl[e] = 0.f;
      if (row_ok && x < nX)
        dl[e] = kVocabRows
                    ? dlogit(s[e] + row_b, lse[x], g[x], tgt[x] - 1 == rr)
                    : dlogit(s[e] + b[x], row_lse, row_g, x == row_t);
      db += dl[e];
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(dl[0], dl[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(dl[2], dl[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    // G is rewritten at the next tile only after the next tile's first
    // cluster barrier, which every CTA reaches after this product
#pragma unroll
    for (int q = 0; q < kRanks; ++q)
      *reinterpret_cast<uint2*>(cluster.map_shared_rank(G, q) + r * kGP +
                                c0) = packed;
    cluster.sync();                        // every CTA's tile is complete
    accumulate_tc(acc, G, xs);
  }
};

template <bool kVocabRows>
__global__ void __cluster_dims__(1, kRanks, 1) __launch_bounds__(kThreads, 1)
fce_bwd_cluster_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                       const float* __restrict__ b,
                       const int* __restrict__ tgt,
                       const float* __restrict__ lse,
                       const float* __restrict__ g, bf16* __restrict__ out,
                       float* __restrict__ db, int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bf16* R = kVocabRows ? w : h;
  const bf16* X = kVocabRows ? h : w;
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;
  const int r0 = blockIdx.x * kCR;
  ClusterBwdEpi<kVocabRows> epi{b, lse, g, tgt,
                                reinterpret_cast<bf16*>(smem_raw + kOffG),
                                r0, nR, nX, 0.f, {}};
  cluster_walk(R, r0, nR, X, nX, 0, (nX + kX - 1) / kX, D, smem_raw, epi);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int d0 = blockIdx.y * kSlice + (warp / 4) * 128 + tig * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int d = d0 + j * 8;
    if (d >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + (warp % 4) * 16 + gid + 8 * half;
      if (r < nR)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<int64_t>(r) * D + d) =
            __floats2bfloat162_rn(epi.acc[j][2 * half],
                                  epi.acc[j][2 * half + 1]);
    }
  }
  if (kVocabRows) {                        // this CTA's 16 rows of db
    const float sum = group_sum<16>(epi.db);
    const int v = r0 + blockIdx.y * 16 + threadIdx.x / 16;
    if (threadIdx.x % 16 == 0 && v < V) db[v] = sum;
  }
}

// ===========================================================================
// f32 (and bf16 with D > 1024): CUDA cores, 16 resident rows a CTA
// ===========================================================================

constexpr int kR = 16;        // resident rows per CTA
constexpr int kKC = 64;       // feature columns per staged chunk
constexpr int kParts = 4;     // column parts of a chunk (K split)
constexpr int kDAcc = 4 * kThreads;   // accumulator columns per CTA
constexpr int kGF = kR + 4;   // pitch (f32) of the dlogits tile

// shared-memory row pitch in elements: the chunk plus 16 bytes, so
// 16-byte cp.async chunks stay aligned and strided rows spread banks
template <typename T>
__host__ __device__ constexpr int pitch() {
  return kKC + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int stage_elems() {
  return (kR + kX) * pitch<T>();
}

// bytes: the double-buffered stage, the partial S tiles and, for the
// backward, the dlogits tile
template <typename T>
constexpr size_t smem_bytes(bool backward) {
  return 2 * stage_elems<T>() * sizeof(T) + kParts * kR * kX * sizeof(float) +
         (backward ? kX * kGF * sizeof(float) : 0);
}

// Walk streamed tiles [xt0, xt1) against the resident rows: for each,
// S = R·Xᵀ over all of D, then `epi(xt, s)` with s[e] = S[t/16][4(t%16)+e]
// (every thread calls it; it may synchronise).
template <typename T, typename Epi>
__device__ __forceinline__ void walk(const T* __restrict__ R, int r0, int nR,
                                     const T* __restrict__ X, int nX, int xt0,
                                     int xt1, int D, T* stages, float* red,
                                     Epi& epi) {
  constexpr int P = pitch<T>();
  const int tid = threadIdx.x;
  const int part = tid / 64, rb = (tid % 64) / 16, cb = tid % 16;
  const int nc = (D + kKC - 1) / kKC;
  const int total = (xt1 - xt0) * nc;
  if (total <= 0) return;

  auto load = [&](int step) {
    T* dst = stages + (step & 1) * stage_elems<T>();
    const int c = step % nc;
    stage_rows<T>(dst, P, R, r0, kR, nR, D, c * kKC, kKC);
    stage_rows<T>(dst + kR * P, P, X, (xt0 + step / nc) * kX, kX, nX, D,
                  c * kKC, kKC);
  };
  float acc[4][4];
  load(0);
  cp_async_commit();
  for (int step = 0; step < total; ++step) {
    const int xt = xt0 + step / nc, c = step % nc;
    if (step + 1 < total) load(step + 1);
    cp_async_commit();
    cp_async_wait_prev();                  // this step's chunk has landed
    __syncthreads();

    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const T* Rs = stages + (step & 1) * stage_elems<T>();
    const T* Xs = Rs + kR * P;
    const int k0 = part * (kKC / kParts);
#pragma unroll
    for (int kk = 0; kk < kKC / kParts; kk += 4) {
      float a[4][4], bb[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(Rs + (rb * 4 + i) * P + k0 + kk, a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load4(Xs + (cb + 16 * j) * P + k0 + kk, bb[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j] += a[i][e] * bb[j][e];
    }
    __syncthreads();                       // stage free for reuse

    if (c == nc - 1) {
      // sum the four column parts; thread t then owns S[t/16][4(t%16)..]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(part * kR + rb * 4 + i) * kX + cb + 16 * j] = acc[i][j];
      __syncthreads();
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        float x[4];
        load4(red + (p * kR + tid / 16) * kX + (tid % 16) * 4, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += x[e];
      }
      epi(xt, s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const float* __restrict__ b, const int* __restrict__ tgt,
               float* __restrict__ part, int N, int V, int D,
               int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);
  float* const red = reinterpret_cast<float*>(stages + 2 * stage_elems<T>());

  const int r0 = blockIdx.x * kR, split = blockIdx.y;
  const int row = r0 + threadIdx.x / 16;
  const int nvt = (V + kX - 1) / kX;
  const int xt0 = split * tiles_per_split;
  const int xt1 = min(xt0 + tiles_per_split, nvt);
  OnlineLse epi{b, V, row < N ? tgt[row] - 1 : -1, -INFINITY, 0.f, 0.f};
  walk<T>(h, r0, N, w, V, xt0, xt1, D, stages, red, epi);
  epi.write(part, split, gridDim.y, N, row);
}

// thread t's share of the dlogits tile into gs ([x][row], f32 holding
// T-rounded values), then acc (16 rows x columns d .. d+3) += dl · X's
// rows of tile xt (read from L2)
template <typename T, bool kVocabRows>
struct BwdEpi {
  const T* X;
  const float *b, *lse, *g;
  const int* tgt;
  float* gs;
  int nX, D, d, rr;
  bool row_ok;
  float row_v;          // dh: the row's lse; dW: the row's bias
  float row_g;          // dh: the row's g
  int row_t;            // dh: the row's target column
  float db;
  float acc[kR][4];
  __device__ void operator()(int xt, float (&s)[4]) {
    const int xq = (threadIdx.x % 16) * 4, r = threadIdx.x / 16;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = xt * kX + xq + e;
      float dl = 0.f;
      if (row_ok && x < nX)
        dl = kVocabRows ? dlogit(s[e] + row_v, lse[x], g[x], tgt[x] - 1 == rr)
                        : dlogit(s[e] + b[x], row_v, row_g, x == row_t);
      db += dl;
      gs[(xq + e) * kGF + r] = round_as(dl, T{});
    }
    __syncthreads();                       // dlogits tile complete
    if (d >= D) return;
    const int x_first = xt * kX, xn = min(kX, nX - x_first);
#pragma unroll 8
    for (int x = 0; x < xn; ++x) {
      float xv[4];
      load4(X + static_cast<int64_t>(x_first + x) * D + d, xv);
      float gv[kR];
#pragma unroll
      for (int q = 0; q < kR / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(gs + x * kGF + 4 * q);
        gv[4 * q] = v.x; gv[4 * q + 1] = v.y;
        gv[4 * q + 2] = v.z; gv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += gv[i] * xv[e];
    }
  }
};

template <typename T, bool kVocabRows>
__global__ void __launch_bounds__(kThreads, 1)
fce_bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
               const float* __restrict__ b, const int* __restrict__ tgt,
               const float* __restrict__ lse, const float* __restrict__ g,
               T* __restrict__ out, float* __restrict__ db, int N, int V,
               int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);
  float* const red = reinterpret_cast<float*>(stages + 2 * stage_elems<T>());
  float* const gs = red + kParts * kR * kX;
  const T* R = kVocabRows ? w : h;
  const T* X = kVocabRows ? h : w;
  const int nR = kVocabRows ? V : N, nX = kVocabRows ? N : V;

  const int r0 = blockIdx.x * kR;
  const int rr = r0 + threadIdx.x / 16;
  const bool ok = rr < nR;
  const int d = static_cast<int>(blockIdx.y * kDAcc + 4 * threadIdx.x);
  BwdEpi<T, kVocabRows> epi{
      X, b, lse, g, tgt, gs, nX, D, d, rr, ok,
      !ok ? 0.f : kVocabRows ? b[rr] : lse[rr],
      !kVocabRows && ok ? g[rr] : 0.f,
      !kVocabRows && ok ? tgt[rr] - 1 : -1, 0.f, {}};
  walk<T>(R, r0, nR, X, nX, 0, (nX + kX - 1) / kX, D, stages, red, epi);
  if (d < D) {
#pragma unroll
    for (int i = 0; i < kR; ++i)
      if (r0 + i < nR)
        store4(out + static_cast<int64_t>(r0 + i) * D + d, epi.acc[i]);
  }
  if (kVocabRows) {
    const float sum = group_sum<16>(epi.db);
    if (blockIdx.y == 0 && threadIdx.x % 16 == 0 && ok) db[rr] = sum;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// the tensor-core cluster kernels take bf16 with D <= 1024
template <typename T>
constexpr bool clustered(int D) {
  return sizeof(T) == 2 && D <= kClusterD;
}

// vocab splits of the forward: as many as keep every CTA resident at
// once (a cluster CTA fills an SM; two generic CTAs share one)
template <typename T>
int fwd_splits(int N, int V, int D, int sms) {
  const bool c = clustered<T>(D);
  const int rows = c ? kCR : kR;
  const int ctas = (N + rows - 1) / rows * (c ? kRanks : 1);
  const int resident = sms * (c ? 1 : 2);
  return max(1, min((V + kX - 1) / kX, resident / ctas));
}

template <typename T>
int fwd(const void* h, const void* w, const float* b, const int* t,
        float* part, float* nll, float* lse, int N, int V, int D,
        int splits, cudaStream_t st) {
  const int tiles_per_split = ((V + kX - 1) / kX + splits - 1) / splits;
  const int rows = clustered<T>(D) ? kCR : kR;
  const int row_tiles = (N + rows - 1) / rows;
  if constexpr (sizeof(T) == 2) {
    if (clustered<T>(D)) {
      auto kernel = fce_fwd_cluster_kernel;
      if (int e = set_smem(kernel, kClusterSmem)) return e;
      kernel<<<dim3(row_tiles, kRanks, splits), kThreads, kClusterSmem,
               st>>>(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                     b, t, part, N, V, D, tiles_per_split);
      if (int e = static_cast<int>(cudaGetLastError())) return e;
      fce_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, splits, N, nll,
                                                         lse);
      return static_cast<int>(cudaGetLastError());
    }
  }
  constexpr size_t smem = smem_bytes<T>(false);
  auto kernel = fce_fwd_kernel<T>;
  if (int e = set_smem(kernel, smem)) return e;
  kernel<<<dim3(row_tiles, splits), kThreads, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), b, t, part, N, V,
      D, tiles_per_split);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  fce_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, splits, N, nll,
                                                     lse);
  return static_cast<int>(cudaGetLastError());
}

// dh (kVocabRows false: out = dh, db unused) or dW and db (true)
template <typename T, bool kVocabRows>
int bwd(const void* h, const void* w, const float* b, const int* t,
        const float* lse, const float* g, void* out, float* db, int N, int V,
        int D, cudaStream_t st) {
  const int nR = kVocabRows ? V : N;
  if constexpr (sizeof(T) == 2) {
    if (clustered<T>(D)) {
      auto kernel = fce_bwd_cluster_kernel<kVocabRows>;
      if (int e = set_smem(kernel, kClusterSmem)) return e;
      kernel<<<dim3((nR + kCR - 1) / kCR, kRanks), kThreads, kClusterSmem,
               st>>>(static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                     b, t, lse, g, static_cast<bf16*>(out), db, N, V, D);
      return static_cast<int>(cudaGetLastError());
    }
  }
  constexpr size_t smem = smem_bytes<T>(true);
  auto kernel = fce_bwd_kernel<T, kVocabRows>;
  if (int e = set_smem(kernel, smem)) return e;
  kernel<<<dim3((nR + kR - 1) / kR, (D + kDAcc - 1) / kDAcc), kThreads, smem,
           st>>>(static_cast<const T*>(h), static_cast<const T*>(w), b, t,
                 lse, g, static_cast<T*>(out), db, N, V, D);
  return static_cast<int>(cudaGetLastError());
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
       const float* lse, const float* g, void* out, int N, int V, int D,
       cudaStream_t st) {
  return bwd<T, false>(h, w, b, t, lse, g, out, nullptr, N, V, D, st);
}

template <typename T>
int dw(const void* h, const void* w, const float* b, const int* t,
       const float* lse, const float* g, void* out, float* db, int N, int V,
       int D, cudaStream_t st) {
  return bwd<T, true>(h, w, b, t, lse, g, out, db, N, V, D, st);
}

}  // namespace

// Each entry returns 0 on a clean launch, -1 for a dtype or feature
// width the kernels were not built for, else the CUDA error code.
// `part` holds 3 x splits x N floats, splits from bigdl_fce_fwd_splits.
extern "C" int bigdl_fce_fwd(int dtype, const void* h, const void* w,
                             const float* b, const int* t, float* part,
                             float* nll, float* lse, int N, int V, int D,
                             int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FCE_DISPATCH(fwd, h, w, b, t, part, nll, lse, N, V, D, splits, st);
}

// how many parts the forward splits the vocab into on a card of `sms`
// SMs
extern "C" int bigdl_fce_fwd_splits(int dtype, int N, int V, int D,
                                    int sms) {
  return dtype == 1 ? fwd_splits<bf16>(N, V, D, sms)
                    : fwd_splits<float>(N, V, D, sms);
}

extern "C" int bigdl_fce_dh(int dtype, const void* h, const void* w,
                            const float* b, const int* t, const float* lse,
                            const float* g, void* dh_out, int N, int V,
                            int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FCE_DISPATCH(dh, h, w, b, t, lse, g, dh_out, N, V, D, st);
}

extern "C" int bigdl_fce_dw(int dtype, const void* h, const void* w,
                            const float* b, const int* t, const float* lse,
                            const float* g, void* dw_out, float* db, int N,
                            int V, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FCE_DISPATCH(dw, h, w, b, t, lse, g, dw_out, db, N, V, D, st);
}

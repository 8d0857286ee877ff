// Flash attention for Hopper (sm_90a): forward with lse, and the
// FlashAttention-2 backward as two kernels (dq; dk and dv fused).
//
// Replaces the Pallas TPU kernels of bigdl_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel  <- `_fwd_kernel`   (the pl.pallas_call at line 190)
//   flash_dq_kernel   <- `_dq_kernel`    (the pl.pallas_call at line 306)
//   flash_dkdv_kernel <- `_dkdv_kernel`  (the pl.pallas_call at line 322)
// They compute the same functions, not the same programs:
//
//   s    = q·kᵀ·scale, or the finite -1e9 where causal and kpos > qpos
//   o    = softmax(s)·v,  lse = logsumexp(s)            (forward)
//   p    = exp(s - lse),  dS = p∘(dO·vᵀ - delta)·scale  (backward)
//   dq   = dS·k,  dk = dSᵀ·q,  dv = pᵀ·dO
//
// with delta = rowsum(dO∘o) - g_lse computed by the caller. Rounding as
// the TPU kernel: p is rounded to v's dtype before p·v (unnormalised, in
// the online softmax) and to dO's dtype before pᵀ·dO; dS to k's dtype for
// dq and to q's dtype for dk (all inputs share one dtype T here). Sums
// are f32 in registers; o/dq/dk/dv are written in T, lse in f32.
//
// Layout: tensors are (B, S, H, D) as the model produces them; element
// [b, s, h, d] sits at ((b*S + s)*H + h)*D + d, so a tile of 64 rows of
// one head is 64 strided rows of D elements. lse and delta are (B, S, H).
//
// Design (simple and right first; the fast version is later work):
// - 256 threads per CTA as a 16 x 16 grid (ty, tx). Every 64 x 64 score
//   tile is computed with thread (ty, tx) owning rows ty*4 + i and
//   columns tx + 16*j (i, j < 4), f32 CUDA-core FMAs over 4-element
//   vector reads of the two shared-memory operand tiles. Row reductions
//   (max, sum) finish with shuffles among the 16 lanes of a row group.
// - Products with the D axis as output (p·v, dS·k, pᵀ·dO, dSᵀ·q) read
//   the 64 x 64 tile back from shared memory (f32, already rounded to
//   the operand dtype) and give each thread 4 rows x D/16 dims.
// - Forward and dq: one CTA per (b·h, 64-query tile), walking key tiles;
//   dkdv: one CTA per (b·h, 64-key tile), walking query tiles from the
//   diagonal down. The TPU grid's sequential axis (scratch carried across
//   grid steps) is this loop inside the CTA; causal tiles that are
//   entirely masked are never loaded.
// - The walked operand tiles are staged with cp.async, double buffered,
//   so the next tile's load overlaps this tile's arithmetic. Rows past
//   the sequence end are zero-filled (cp.async src-size 0) and masked:
//   any S and Sq != Skv (non-causal) work, head dims 64 and 128.
// - The kernels allocate nothing; the Python wrapper allocates outputs
//   and checks shapes, dtypes, contiguity and alignment.
//
// Bound on the H100: at the training shapes (B 4, S 2048, H 8, D 128,
// bf16, causal) the forward does 34.4 GFLOP on 67 MB of inputs and
// outputs, about 510 flops a byte, and the backward kernels more: above
// the ~295 flops/byte at which the tensor cores bind, so all three are
// bound by operations. These kernels run them on the CUDA cores (f32
// FMA), not the tensor cores: mma/wgmma with TMA-fed tiles is the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kThreads = 256;      // 16 x 16 thread grid
constexpr int kPP = kTile + 1;     // pitch (floats) of the f32 p/dS tile
constexpr float kMask = -1e9f;     // finite mask value, as the TPU kernel

// shared-memory row pitch in elements: D plus 16 bytes of padding, so
// 16-byte cp.async chunks stay aligned and strided rows spread banks
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * pitch<T, D>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
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
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                      const float (&x)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&a);
  v.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}

// x as a product operand of dtype T sees it
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
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

// Stage rows [row0, row0 + 64) of head h of x (B, S, H, D) into dst
// (64 rows at pitch P); rows >= S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* x, int b, int h,
                                          int row0, int S, int H) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int P = pitch<T, D>();
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, w = (c % kChunks) * kVec;
    const int s = row0 + r;
    const bool ok = s < S;
    const T* g = ok ? x + ((static_cast<int64_t>(b) * S + s) * H + h) * D + w
                    : x;
    cp_async16(dst + r * P + w, g, ok);
  }
}

// acc[i][j] = A[ty*4 + i] · B[tx + 16*j] over D (both tiles at pitch P)
template <typename T, int D>
__device__ __forceinline__ void dot_tile(const T* A, const T* B, int ty,
                                         int tx, float (&acc)[4][4]) {
  constexpr int P = pitch<T, D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float a[4][4], bb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(A + (ty * 4 + i) * P + d, a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(B + (tx + 16 * j) * P + d, bb[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j] += a[i][e] * bb[j][e];
  }
}

// acc[i][u*4 + e] += Σ_c W[ty*4 + i][c] · X[c][tx*4 + 64*u + e]: W the
// f32 64 x 64 tile at pitch kPP, X a staged tile at pitch P
template <typename T, int D>
__device__ __forceinline__ void mul_tile(const float* W, const T* X, int ty,
                                         int tx, float (&acc)[4][D / 16]) {
  constexpr int P = pitch<T, D>();
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty * 4 + i) * kPP + c];
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      float x[4];
      load4(X + c * P + tx * 4 + 64 * u, x);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][u * 4 + e] += w[i] * x[e];
    }
  }
}

// Write rows ty*4 + i (if below S) of a (B, S, H, D) output, scaled by
// inv[i]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[4][D / 16],
                                           const float (&inv)[4], int b,
                                           int h, int row0, int S, int H,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty * 4 + i;
    if (s >= S) continue;
    T* row = out + ((static_cast<int64_t>(b) * S + s) * H + h) * D;
#pragma unroll
    for (int u = 0; u < D / 64; ++u) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][u * 4 + e] * inv[i];
      store4(row + tx * 4 + 64 * u, x);
    }
  }
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// number of key tiles a query tile starting at q0 attends
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Skv,
                                         bool causal) {
  const int nk = (Skv + kTile - 1) / kTile;
  if (!causal) return nk;
  const int q_last = min(q0 + kTile - 1, Sq - 1);
  return min(nk, q_last / kTile + 1);
}

// ---------------------------------------------------------------------------
// forward: o and lse
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv,
                 float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kT = kTile * pitch<T, D>();          // elements per tile
  T* const qs = reinterpret_cast<T*>(smem_raw);
  T* const kv = qs + kT;                              // [2][K|V][tile]
  float* const ps = reinterpret_cast<float*>(kv + 4 * kT);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heavy tiles first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nkt = key_tiles(q0, Sq, Skv, causal);

  float acc[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < D / 16; ++d) acc[i][d] = 0.f;
  }

  load_tile<T, D>(qs, q, b, h, q0, Sq, H);
  load_tile<T, D>(kv, k, b, h, 0, Skv, H);
  load_tile<T, D>(kv + kT, v, b, h, 0, Skv, H);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const T* ks = kv + (kt & 1) * 2 * kT;
    const T* vs = ks + kT;
    if (kt + 1 < nkt) {
      T* nk = kv + ((kt + 1) & 1) * 2 * kT;
      load_tile<T, D>(nk, k, b, h, (kt + 1) * kTile, Skv, H);
      load_tile<T, D>(nk + kT, v, b, h, (kt + 1) * kTile, Skv, H);
    }
    cp_async_commit();
    cp_async_wait_prev();                  // tile kt (and q) has landed
    __syncthreads();

    float s[4][4];
    dot_tile<T, D>(qs, ks, ty, tx, s);
    const int k0 = kt * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = kpos >= Skv                ? -INFINITY   // past the end
                  : (causal && kpos > qpos) ? kMask
                                            : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * kPP + tx + 16 * j] = round_as(p, T{});
      }
      l[i] = l[i] * corr + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < D / 16; ++d) acc[i][d] *= corr;
    }
    __syncthreads();                       // p tile complete
    mul_tile<T, D>(ps, vs, ty, tx, acc);
    __syncthreads();                       // buffers free for reuse
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  store_rows<T, D>(o, acc, inv, b, h, q0, Sq, H, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = q0 + ty * 4 + i;
      if (s < Sq)
        lse[(static_cast<int64_t>(b) * Sq + s) * H + h] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int Sq, int Skv, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kT = kTile * pitch<T, D>();
  T* const qs = reinterpret_cast<T*>(smem_raw);
  T* const dos = qs + kT;
  T* const kv = dos + kT;                             // [2][K|V][tile]
  float* const ds_tile = reinterpret_cast<float*>(kv + 4 * kT);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nkt = key_tiles(q0, Sq, Skv, causal);

  float acc[4][D / 16], row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    const int64_t at = (static_cast<int64_t>(b) * Sq + s) * H + h;
    row_lse[i] = s < Sq ? lse[at] : 0.f;
    row_delta[i] = s < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int d = 0; d < D / 16; ++d) acc[i][d] = 0.f;
  }

  load_tile<T, D>(qs, q, b, h, q0, Sq, H);
  load_tile<T, D>(dos, dout, b, h, q0, Sq, H);
  load_tile<T, D>(kv, k, b, h, 0, Skv, H);
  load_tile<T, D>(kv + kT, v, b, h, 0, Skv, H);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const T* ks = kv + (kt & 1) * 2 * kT;
    const T* vs = ks + kT;
    if (kt + 1 < nkt) {
      T* nk = kv + ((kt + 1) & 1) * 2 * kT;
      load_tile<T, D>(nk, k, b, h, (kt + 1) * kTile, Skv, H);
      load_tile<T, D>(nk + kT, v, b, h, (kt + 1) * kTile, Skv, H);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<T, D>(qs, ks, ty, tx, s);
    dot_tile<T, D>(dos, vs, ty, tx, dp);
    const int k0 = kt * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float sc = kpos >= Skv                ? -INFINITY
                         : (causal && kpos > qpos) ? kMask
                                                   : s[i][j] * scale;
        const float p = expf(sc - row_lse[i]);
        const float ds = p * (dp[i][j] - row_delta[i]) * scale;
        ds_tile[(ty * 4 + i) * kPP + tx + 16 * j] = round_as(ds, T{});
      }
    }
    __syncthreads();
    mul_tile<T, D>(ds_tile, ks, ty, tx, acc);
    __syncthreads();
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dq, acc, one, b, h, q0, Sq, H, ty, tx);
}

// ---------------------------------------------------------------------------
// backward: dk and dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int H, int Sq, int Skv, float scale,
                  int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kT = kTile * pitch<T, D>();
  T* const ks = reinterpret_cast<T*>(smem_raw);
  T* const vs = ks + kT;
  T* const qd = vs + kT;                              // [2][Q|dO][tile]
  float* const w_tile = reinterpret_cast<float*>(qd + 4 * kT);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // heavy tiles first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nq = (Sq + kTile - 1) / kTile;
  // causal: query tiles wholly before this key tile see none of its keys
  const int qt0 = causal ? min(k0 / kTile, nq) : 0;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < D / 16; ++d) dk_acc[i][d] = dv_acc[i][d] = 0.f;

  load_tile<T, D>(ks, k, b, h, k0, Skv, H);
  load_tile<T, D>(vs, v, b, h, k0, Skv, H);
  if (qt0 < nq) {
    load_tile<T, D>(qd, q, b, h, qt0 * kTile, Sq, H);
    load_tile<T, D>(qd + kT, dout, b, h, qt0 * kTile, Sq, H);
  }
  cp_async_commit();
  for (int qt = qt0; qt < nq; ++qt) {
    const T* qs = qd + ((qt - qt0) & 1) * 2 * kT;
    const T* dos = qs + kT;
    if (qt + 1 < nq) {
      T* nq_tile = qd + ((qt + 1 - qt0) & 1) * 2 * kT;
      load_tile<T, D>(nq_tile, q, b, h, (qt + 1) * kTile, Sq, H);
      load_tile<T, D>(nq_tile + kT, dout, b, h, (qt + 1) * kTile, Sq, H);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    // transposed tiles: rows are this CTA's keys, columns the queries
    float s[4][4], dp[4][4], col_lse[4], col_delta[4];
    const int q0 = qt * kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qpos = q0 + tx + 16 * j;
      const int64_t at = (static_cast<int64_t>(b) * Sq + qpos) * H + h;
      col_lse[j] = qpos < Sq ? lse[at] : 0.f;
      col_delta[j] = qpos < Sq ? delta[at] : 0.f;
    }
    dot_tile<T, D>(ks, qs, ty, tx, s);
    dot_tile<T, D>(vs, dos, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const float sc = qpos >= Sq                 ? -INFINITY
                         : (causal && kpos > qpos) ? kMask
                                                   : s[i][j] * scale;
        s[i][j] = expf(sc - col_lse[j]);                  // p
        w_tile[(ty * 4 + i) * kPP + tx + 16 * j] = round_as(s[i][j], T{});
      }
    }
    __syncthreads();                       // pᵀ tile complete
    mul_tile<T, D>(w_tile, dos, ty, tx, dv_acc);
    __syncthreads();                       // pᵀ tile read
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ds = s[i][j] * (dp[i][j] - col_delta[j]) * scale;
        w_tile[(ty * 4 + i) * kPP + tx + 16 * j] = round_as(ds, T{});
      }
    __syncthreads();                       // dSᵀ tile complete
    mul_tile<T, D>(w_tile, qs, ty, tx, dk_acc);
    __syncthreads();                       // buffers free for reuse
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dk, dk_acc, one, b, h, k0, Skv, H, ty, tx);
  store_rows<T, D>(dv, dv_acc, one, b, h, k0, Skv, H, ty, tx);
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

constexpr size_t kWTileBytes = kTile * kPP * sizeof(float);

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, int H, int Sq, int Skv, float scale, int causal,
        cudaStream_t st) {
  const size_t smem = 5 * tile_bytes<T, D>() + kWTileBytes;
  auto kernel = flash_fwd_kernel<T, D>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Sq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Skv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dq_out, int B, int H,
       int Sq, int Skv, float scale, int causal, cudaStream_t st) {
  const size_t smem = 6 * tile_bytes<T, D>() + kWTileBytes;
  auto kernel = flash_dq_kernel<T, D>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Sq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq_out), H, Sq, Skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, void* dk, void* dv, int B,
         int H, int Sq, int Skv, float scale, int causal, cudaStream_t st) {
  const size_t smem = 6 * tile_bytes<T, D>() + kWTileBytes;
  auto kernel = flash_dkdv_kernel<T, D>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(B * H, (Skv + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// dispatch on (dtype code, head dim): 0 = float32, 1 = bfloat16
#define BIGDL_FLASH_DISPATCH(FN, ...)                                    \
  do {                                                                    \
    if (dtype == 0 && D == 64) return FN<float, 64>(__VA_ARGS__);         \
    if (dtype == 0 && D == 128) return FN<float, 128>(__VA_ARGS__);       \
    if (dtype == 1 && D == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__); \
    if (dtype == 1 && D == 128)                                           \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                         \
    return -1;                                                            \
  } while (0)

}  // namespace

// Each entry returns 0 on a clean launch, -1 for a (dtype, head dim) the
// kernels were not built for, else the CUDA error code of the launch.
extern "C" int bigdl_flash_fwd(int dtype, const void* q, const void* k,
                               const void* v, void* o, float* lse, int B,
                               int H, int Sq, int Skv, int D, float scale,
                               int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FLASH_DISPATCH(fwd, q, k, v, o, lse, B, H, Sq, Skv, scale, causal,
                       st);
}

extern "C" int bigdl_flash_dq(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* lse, const float* delta,
                              void* dq_out, int B, int H, int Sq, int Skv,
                              int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, B, H, Sq, Skv,
                       scale, causal, st);
}

extern "C" int bigdl_flash_dkdv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta,
                                void* dk, void* dv, int B, int H, int Sq,
                                int Skv, int D, float scale, int causal,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BIGDL_FLASH_DISPATCH(dkdv, q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                       Skv, scale, causal, st);
}

// Paged attention for Hopper (sm_90a): grouped causal attention of q
// straight off a paged K/V pool.
//
// Replaces the Pallas TPU kernel `_kernel` launched by `paged_attention`
// in bigdl_tpu/ops/pallas/paged_attention.py (the pl.pallas_call at
// line 225). It computes the same function, not the same program:
//
//   out[b, t, h, :] = softmax_k(q[b,t,h]·K[b,k,h/G] * scale, masked to key
//                     positions k <= q_start[b] + t with the finite -1e9)
//                     · V[b,k,h/G]
//
// where logical key position k of row b lives in physical page
// table[b, k / S], slot k % S, of the (num_pages, S, KV, D) pools.
//
// Design (simple and right first; the fast version is later work):
// - One CTA of 4 warps per (row b, kv head, tile of query rows). The G
//   query heads that share a kv head fold into the tile's rows (row r is
//   query column r / G, head r % G), as the TPU kernel folds them into the
//   matmul's row dimension; the card needs no padding of G.
// - The TPU grid's sequential page axis (scratch carried across pages)
//   becomes a loop over the row's pages inside the CTA. The CTA reads the
//   block table and q_start itself (no scalar prefetch).
// - Pages whose first slot lies past the tile's last query position are
//   never loaded: a short row in a long table reads only its own pages.
// - K/V pages are staged in shared memory with cp.async, double buffered,
//   so the next page's load overlaps this page's arithmetic.
// - Each warp owns RPW query rows; each lane owns D/32 of the head dims.
//   Scores are f32 dot products finished with warp shuffles; the running
//   max, sum and accumulator are f32 in registers (online softmax). P·V
//   takes p rounded to the pool dtype, as the TPU kernel does. Output f32.
// - The kernel allocates nothing; the Python wrapper allocates `out` and
//   checks shapes, dtypes, contiguity and alignment.
//
// Bound on the H100: decode (T = 1) moves the K/V pages each row needs
// and does ~4·D flops per key and head, far under the ~295 flops/byte at
// which the tensor cores would bind, so it is bound by bytes. Its grid of
// B·KV CTAs (16 at B=8, KV=2) underfills the 132 SMs: splitting the key
// range across CTAs (split-KV) is the next step. Prefill (T = the prompt
// bucket) is bound by operations, and this kernel does them on the CUDA
// cores, not the tensor cores (wgmma and TMA are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyChunk = 8;       // keys scored per online-softmax update
constexpr float kMask = -1e9f;     // finite mask value, as the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p as the P·V product sees it: rounded to the pool dtype
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage physical page `page`, kv head `h`, of both pools into smem
// (S rows of D elements each, rows contiguous).
template <typename T, int D>
__device__ __forceinline__ void load_page(T* ks, T* vs, const T* kp,
                                          const T* vp, int64_t page, int h,
                                          int S, int KV) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int kPerSlot = D / kVec;
  const int64_t base = page * S * KV * D + static_cast<int64_t>(h) * D;
  for (int c = threadIdx.x; c < S * kPerSlot; c += kThreads) {
    const int s = c / kPerSlot, w = (c % kPerSlot) * kVec;
    const int64_t g = base + static_cast<int64_t>(s) * KV * D + w;
    cp_async16(ks + s * D + w, kp + g);
    cp_async16(vs + s * D + w, vp + g);
  }
}

template <typename T, int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ q_start,
                       float* __restrict__ out, int T_, int H, int KV,
                       int S, int P, float scale) {
  constexpr int kDpl = D / 32;           // head dims per lane
  constexpr int kRows = kWarps * RPW;    // query rows per CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);   // [2][K|V][S][D]

  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int G = H / KV;
  const int rows_total = T_ * G;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qs = q_start[b];
  const int q_last = qs + (min(row0 + kRows, rows_total) - 1) / G;
  // pages j with j*S <= q_last hold every key any row here may attend
  const int n_pages = min(P, q_last / S + 1);

  float qr[RPW][kDpl], acc[RPW][kDpl], m[RPW], l[RPW];
  int qpos[RPW];
  int64_t obase[RPW];
  bool live[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    live[i] = r < rows_total;
    const int t = r / G, head = h * G + r % G;
    qpos[i] = qs + t;
    obase[i] = ((static_cast<int64_t>(b) * T_ + t) * H + head) * D +
               lane * kDpl;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDpl; ++d) {
      qr[i][d] = live[i] ? to_f32(q[obase[i] + d]) : 0.f;
      acc[i][d] = 0.f;
    }
  }

  const int* row_table = table + static_cast<int64_t>(b) * P;
  if (n_pages > 0) {
    load_page<T, D>(buf, buf + S * D, kp, vp, row_table[0], h, S, KV);
  }
  cp_async_commit();
  for (int j = 0; j < n_pages; ++j) {
    T* const ks = buf + (j & 1) * 2 * S * D;
    T* const vs = ks + S * D;
    if (j + 1 < n_pages) {
      T* const nk = buf + ((j + 1) & 1) * 2 * S * D;
      load_page<T, D>(nk, nk + S * D, kp, vp, row_table[j + 1], h, S, KV);
    }
    cp_async_commit();
    cp_async_wait_prev();                // page j has landed
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (!live[i]) continue;            // warp-uniform
      for (int c = 0; c < S; c += kKeyChunk) {
        float s[kKeyChunk];
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) {
          float part = 0.f;
          if (c + kk < S) {
            const T* kr = ks + (c + kk) * D + lane * kDpl;
#pragma unroll
            for (int d = 0; d < kDpl; ++d) part += qr[i][d] * to_f32(kr[d]);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          s[kk] = part;
        }
        float m_chunk = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) {
          const int slot = c + kk;
          const int kpos = j * S + slot;
          s[kk] = slot >= S          ? -INFINITY   // past the page: no key
                  : kpos > qpos[i]   ? kMask
                                     : s[kk] * scale;
          m_chunk = fmaxf(m_chunk, s[kk]);
        }
        const float m_new = fmaxf(m[i], m_chunk);
        const float corr = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int d = 0; d < kDpl; ++d) acc[i][d] *= corr;
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) {
          const float p = expf(s[kk] - m_new);
          psum += p;
          if (c + kk < S) {
            const float pr = round_as(p, T{});
            const T* vr = vs + (c + kk) * D + lane * kDpl;
#pragma unroll
            for (int d = 0; d < kDpl; ++d) acc[i][d] += pr * to_f32(vr[d]);
          }
        }
        l[i] = l[i] * corr + psum;
        m[i] = m_new;
      }
    }
    __syncthreads();                     // buffer j&1 is refilled next
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int d = 0; d < kDpl; ++d) out[obase[i] + d] = acc[i][d] / l[i];
  }
}

template <typename T, int D, int RPW>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* q_start, float* out, int B, int T_, int H, int KV,
           int S, int P, float scale, cudaStream_t stream) {
  constexpr int kRows = kWarps * RPW;
  const int rows_total = T_ * (H / KV);
  const dim3 grid(B * KV, (rows_total + kRows - 1) / kRows);
  const size_t smem = 4ull * S * D * sizeof(T);
  auto kernel = paged_attention_kernel<T, D, RPW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, q_start, out, T_, H, KV, S, P,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rows(const void* q, const void* kp, const void* vp,
                const int* table, const int* q_start, float* out, int B,
                int T_, int H, int KV, int S, int P, float scale,
                cudaStream_t stream) {
  // decode tiles hold a handful of rows (T = 1, G heads): one row per
  // warp; prefill tiles take four rows per warp
  if (T_ * (H / KV) <= kWarps)
    return launch<T, D, 1>(q, kp, vp, table, q_start, out, B, T_, H, KV, S,
                           P, scale, stream);
  return launch<T, D, 4>(q, kp, vp, table, q_start, out, B, T_, H, KV, S, P,
                         scale, stream);
}

template <typename T>
int launch_dims(const void* q, const void* kp, const void* vp,
                const int* table, const int* q_start, float* out, int B,
                int T_, int H, int KV, int D, int S, int P, float scale,
                cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_rows<T, 32>(q, kp, vp, table, q_start, out, B, T_, H,
                                KV, S, P, scale, stream);
    case 64:
      return launch_rows<T, 64>(q, kp, vp, table, q_start, out, B, T_, H,
                                KV, S, P, scale, stream);
    case 128:
      return launch_rows<T, 128>(q, kp, vp, table, q_start, out, B, T_, H,
                                 KV, S, P, scale, stream);
    case 256:
      return launch_rows<T, 256>(q, kp, vp, table, q_start, out, B, T_, H,
                                 KV, S, P, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32 pools, 1 = bfloat16 pools. Returns 0 on a clean
// launch, -1 for a head dim the kernel was not built for, else the CUDA
// error code of the launch.
extern "C" int bigdl_paged_attention(int dtype, const void* q,
                                     const void* kp, const void* vp,
                                     const int* table, const int* q_start,
                                     float* out, int B, int T, int H, int KV,
                                     int D, int S, int P, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dims<float>(q, kp, vp, table, q_start, out, B, T, H, KV, D,
                              S, P, scale, st);
  if (dtype == 1)
    return launch_dims<__nv_bfloat16>(q, kp, vp, table, q_start, out, B, T,
                                      H, KV, D, S, P, scale, st);
  return -2;
}

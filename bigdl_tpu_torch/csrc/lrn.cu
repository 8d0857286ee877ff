// Cross-map local response normalisation for Hopper (sm_90a): forward and
// analytic backward over the channels of an NCHW activation.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_bwd_kernel` launched
// by `lrn` through `_call` in bigdl_tpu/ops/pallas/lrn.py (the
// pl.pallas_call at line 150). It computes the same function:
//
//   r   = x, or max(x, 0) with relu
//   s_c = k + alpha/n * sum_{j in win(c)} r_j^2,  win(c) = [c-lo, c+hi],
//         lo = (n-1)/2, hi = n-1-lo
//   y_c = r_c * s_c^-beta
//   dx_c = g_c*s_c^-beta - (2*alpha*beta/n) * r_c * sum_{j in adj(c)} t_j,
//         t_j = g_j*r_j*s_j^-beta / s_j,  adj(c) = [c-hi, c+lo]
//         (masked by x_c > 0 with relu)
//
// Design (simple and right first):
// - Not the TPU's layout. The (H*W, C, N) view and the banded (C, C)
//   window matmul exist for the TPU's lanes and MXU; here the activation
//   stays NCHW as cuDNN writes it. One thread per (n, VEC positions of
//   h*w) walks the C channels in order, so adjacent threads read adjacent
//   h*w of one channel plane: every read and write is coalesced. VEC = 4
//   (16-byte f32 / 8-byte bf16 accesses) where H*W and the pointers allow,
//   else 1.
// - Up to kMaxSize (9) the window lives in a register ring of n f32
//   values per position (the window size is a template parameter, 1..9,
//   so the ring is fully unrolled into registers). Each window sum is taken afresh over the
//   ring in channel order, not as a running add/subtract sum, whose
//   rounding would drift across the channels.
// - Backward reads x ahead of the output channel by n-1: s_j, s_j^-beta
//   and t_j are recomputed on the fly as soon as r over win(j) is in the
//   ring, t goes into a second ring that holds exactly adj(c), and g and
//   s^-beta wait in short rings until channel c is written. Nothing but x
//   is saved from the forward.
// - Past kMaxSize the window is a runtime value (`lrn_fwd_any_kernel`,
//   `lrn_bwd_any_kernel`): no register ring, so each window sum is taken
//   afresh, in channel order, from the channel column the thread walks
//   (r^2 of the in-range channels of win(c), read again from L1/L2),
//   which gives the sums the ring would. The backward walks the column
//   twice: first t_j for every channel into an f32 scratch column that
//   the wrapper allocates (the thread's own, so no barrier), then dx_c
//   with the adjoint sum over the scratch, s_c recomputed.
// - All arithmetic is f32; inputs and outputs keep the activation dtype.
//
// Bound on the H100: bytes. The forward reads x and writes y, the
// backward reads g and x and writes dx, each once, with some 5*n flops an
// element, far under the card's ~20 f32 flops per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSize = 9;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int BYTES> struct Raw;
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(*p);
  } else {
    using R = typename Raw<sizeof(T) * VEC>::type;
    R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_f32(e[v]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(in[0]);
  } else {
    using R = typename Raw<sizeof(T) * VEC>::type;
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) e[v] = from_f32<T>(in[v]);
    *reinterpret_cast<R*>(p) = raw;
  }
}

// s^-beta: square roots for the betas the model zoo uses (mode 0: 0.75,
// 1: 0.5, 2: 1), pow otherwise; as ops/__init__.py:pow_neg_beta
__device__ __forceinline__ float pow_neg_beta(float s, int mode, float beta) {
  if (mode == 0) {
    float r = rsqrtf(s);
    return r * sqrtf(r);
  }
  if (mode == 1) return rsqrtf(s);
  if (mode == 2) return 1.0f / s;
  return powf(s, -beta);
}

// r of one channel: x, or max(x, 0) with relu (a NaN stays NaN)
template <int VEC>
__device__ __forceinline__ void relu_if(float (&r)[VEC], int relu) {
  if (relu) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) r[v] = r[v] < 0.0f ? 0.0f : r[v];
  }
}

template <int N, int VEC>
__device__ __forceinline__ void shift(float (&ring)[N][VEC]) {
#pragma unroll
  for (int m = 0; m + 1 < N; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) ring[m][v] = ring[m + 1][v];
}

template <typename T, int SIZE, int VEC>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int C,
                   int64_t HW, int64_t HWv, int64_t total, float coef,
                   float k, int mode, float beta, int relu) {
  constexpr int LO = (SIZE - 1) / 2, HI = SIZE - 1 - LO;
  const int64_t idx = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t n = idx / HWv;
  const int64_t base = n * C * HW + (idx - n * HWv) * VEC;
  float ring[SIZE][VEC];  // r of channels i-SIZE+1 .. i
#pragma unroll
  for (int m = 0; m < SIZE; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) ring[m][v] = 0.0f;
  for (int i = 0; i < C + HI; ++i) {
    shift(ring);
    if (i < C) {
      load_vec<T, VEC>(x + base + i * HW, ring[SIZE - 1]);
      relu_if(ring[SIZE - 1], relu);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) ring[SIZE - 1][v] = 0.0f;
    }
    const int c = i - HI;  // its window [c-LO, c+HI] is the ring
    if (c < 0) continue;
    float out[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float sum = 0.0f;
#pragma unroll
      for (int m = 0; m < SIZE; ++m) sum += ring[m][v] * ring[m][v];
      out[v] = ring[LO][v] * pow_neg_beta(k + coef * sum, mode, beta);
    }
    store_vec<T, VEC>(y + base + c * HW, out);
  }
}

template <typename T, int SIZE, int VEC>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   T* __restrict__ dx, int C, int64_t HW, int64_t HWv,
                   int64_t total, float coef, float k, int mode, float beta,
                   float coef2, int relu) {
  constexpr int LO = (SIZE - 1) / 2, HI = SIZE - 1 - LO;
  const int64_t idx = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t n = idx / HWv;
  const int64_t base = n * C * HW + (idx - n * HWv) * VEC;
  // step i reads channel i; j = i - HI is the channel whose window is
  // complete; c = j - LO = i - SIZE + 1 is the channel written
  float rr[SIZE][VEC];     // r over [i-SIZE+1, i] = [c, i]
  float gg[LO + 1][VEC];   // g over [c, j]
  float sb[LO + 1][VEC];   // s^-beta over [c, j]
  float tt[SIZE][VEC];     // t over [c-HI, c+LO], the adjoint window of c
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
#pragma unroll
    for (int m = 0; m < SIZE; ++m) rr[m][v] = tt[m][v] = 0.0f;
#pragma unroll
    for (int m = 0; m <= LO; ++m) gg[m][v] = sb[m][v] = 0.0f;
  }
  for (int i = 0; i < C + SIZE - 1; ++i) {
    shift(rr);
    shift(gg);
    shift(sb);
    shift(tt);
    if (i < C) {
      load_vec<T, VEC>(x + base + i * HW, rr[SIZE - 1]);
      relu_if(rr[SIZE - 1], relu);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) rr[SIZE - 1][v] = 0.0f;
    }
    const int j = i - HI;
    if (j >= 0 && j < C) {
      load_vec<T, VEC>(g + base + j * HW, gg[LO]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float sum = 0.0f;
#pragma unroll
        for (int m = 0; m < SIZE; ++m) sum += rr[m][v] * rr[m][v];
        const float s = k + coef * sum;
        const float b = pow_neg_beta(s, mode, beta);
        sb[LO][v] = b;
        tt[SIZE - 1][v] = gg[LO][v] * rr[LO][v] * b / s;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        gg[LO][v] = sb[LO][v] = tt[SIZE - 1][v] = 0.0f;
    }
    const int c = i - SIZE + 1;
    if (c < 0) continue;
    float out[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < SIZE; ++m) acc += tt[m][v];
      const float r = rr[0][v];
      const float d = gg[0][v] * sb[0][v] - coef2 * r * acc;
      out[v] = (relu && !(r > 0.0f)) ? 0.0f : d;
    }
    store_vec<T, VEC>(dx + base + c * HW, out);
  }
}

// r of channel j at this thread's positions, or zeros past [0, C)
template <typename T, int VEC>
__device__ __forceinline__ void load_r(const T* __restrict__ x, int64_t at,
                                       int j, int C, int64_t HW, int relu,
                                       float (&r)[VEC]) {
  if (j < 0 || j >= C) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) r[v] = 0.0f;
    return;
  }
  load_vec<T, VEC>(x + at + j * HW, r);
  relu_if(r, relu);
}

// s_c = k + coef * sum over win(c) = [c-lo, c-lo+size-1] of r^2, the sum
// taken in channel order from 0 as the ring's (out-of-range channels add
// nothing)
template <typename T, int VEC>
__device__ __forceinline__ void window_s(const T* __restrict__ x,
                                         int64_t at, int c, int C,
                                         int64_t HW, int size, int lo,
                                         float coef, float k, int relu,
                                         float (&s)[VEC]) {
  float sum[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) sum[v] = 0.0f;
  for (int j = max(c - lo, 0); j <= min(c - lo + size - 1, C - 1); ++j) {
    float r[VEC];
    load_r<T, VEC>(x, at, j, C, HW, relu, r);
#pragma unroll
    for (int v = 0; v < VEC; ++v) sum[v] += r[v] * r[v];
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) s[v] = k + coef * sum[v];
}

// Past kMaxSize: the forward with the window size a runtime value
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_any_kernel(const T* __restrict__ x, T* __restrict__ y, int C,
                       int64_t HW, int64_t HWv, int64_t total, int size,
                       float coef, float k, int mode, float beta, int relu) {
  const int lo = (size - 1) / 2;
  const int64_t idx = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t n = idx / HWv;
  const int64_t base = n * C * HW + (idx - n * HWv) * VEC;
  for (int c = 0; c < C; ++c) {
    float s[VEC], r[VEC], out[VEC];
    window_s<T, VEC>(x, base, c, C, HW, size, lo, coef, k, relu, s);
    load_r<T, VEC>(x, base, c, C, HW, relu, r);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      out[v] = r[v] * pow_neg_beta(s[v], mode, beta);
    store_vec<T, VEC>(y + base + c * HW, out);
  }
}

// Past kMaxSize: the backward with the window size a runtime value. Pass
// 1 writes t_j = g_j*r_j*s_j^-beta / s_j of every channel to `tbuf` (f32,
// laid out as x); pass 2 takes the adjoint sum of c, adj(c) = [c-hi,
// c+lo], over it in channel order, as the ring's
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_any_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       T* __restrict__ dx, float* __restrict__ tbuf, int C,
                       int64_t HW, int64_t HWv, int64_t total, int size,
                       float coef, float k, int mode, float beta, float coef2,
                       int relu) {
  const int lo = (size - 1) / 2, hi = size - 1 - lo;
  const int64_t idx = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t n = idx / HWv;
  const int64_t base = n * C * HW + (idx - n * HWv) * VEC;
  for (int j = 0; j < C; ++j) {
    float s[VEC], r[VEC], gj[VEC], t[VEC];
    window_s<T, VEC>(x, base, j, C, HW, size, lo, coef, k, relu, s);
    load_r<T, VEC>(x, base, j, C, HW, relu, r);
    load_vec<T, VEC>(g + base + j * HW, gj);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      t[v] = gj[v] * r[v] * pow_neg_beta(s[v], mode, beta) / s[v];
    store_vec<float, VEC>(tbuf + base + j * HW, t);
  }
  for (int c = 0; c < C; ++c) {
    float acc[VEC], s[VEC], r[VEC], gc[VEC], out[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (int j = max(c - hi, 0); j <= min(c + lo, C - 1); ++j) {
      float t[VEC];
      load_vec<float, VEC>(tbuf + base + j * HW, t);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += t[v];
    }
    window_s<T, VEC>(x, base, c, C, HW, size, lo, coef, k, relu, s);
    load_r<T, VEC>(x, base, c, C, HW, relu, r);
    load_vec<T, VEC>(g + base + c * HW, gc);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float d =
          gc[v] * pow_neg_beta(s[v], mode, beta) - coef2 * r[v] * acc[v];
      out[v] = (relu && !(r[v] > 0.0f)) ? 0.0f : d;
    }
    store_vec<T, VEC>(dx + base + c * HW, out);
  }
}

int beta_mode(float beta) {
  return beta == 0.75f ? 0 : beta == 0.5f ? 1 : beta == 1.0f ? 2 : 3;
}

template <typename T>
bool aligned(const void* p, int vec) {
  return reinterpret_cast<uintptr_t>(p) % (vec * sizeof(T)) == 0;
}

struct Args {
  int N, C;
  int64_t HW;
  float alpha, beta, k;
  int size, relu;
  float* tbuf;       // the backward's t scratch past kMaxSize
  cudaStream_t st;
};

template <typename T, int SIZE, int VEC>
int launch(bool bwd, const void* g, const void* x, void* out,
           const Args& a) {
  const int64_t HWv = a.HW / VEC;
  const int64_t total = (int64_t)a.N * HWv;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return -4;
  const float coef = a.alpha / a.size;
  const int mode = beta_mode(a.beta);
  if (bwd) {
    lrn_bwd_kernel<T, SIZE, VEC><<<(unsigned)blocks, kThreads, 0, a.st>>>(
        static_cast<const T*>(g), static_cast<const T*>(x),
        static_cast<T*>(out), a.C, a.HW, HWv, total, coef, a.k, mode, a.beta,
        2.0f * a.alpha * a.beta / a.size, a.relu);
  } else {
    lrn_fwd_kernel<T, SIZE, VEC><<<(unsigned)blocks, kThreads, 0, a.st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), a.C, a.HW, HWv,
        total, coef, a.k, mode, a.beta, a.relu);
  }
  return (int)cudaGetLastError();
}

// past kMaxSize (SIZE 0): the runtime-size kernels
template <typename T, int VEC>
int launch_any(bool bwd, const void* g, const void* x, void* out,
               const Args& a) {
  const int64_t HWv = a.HW / VEC;
  const int64_t total = (int64_t)a.N * HWv;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return -4;
  const float coef = a.alpha / a.size;
  const int mode = beta_mode(a.beta);
  if (bwd) {
    if (a.tbuf == nullptr) return -5;
    lrn_bwd_any_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, a.st>>>(
        static_cast<const T*>(g), static_cast<const T*>(x),
        static_cast<T*>(out), a.tbuf, a.C, a.HW, HWv, total, a.size, coef,
        a.k, mode, a.beta, 2.0f * a.alpha * a.beta / a.size, a.relu);
  } else {
    lrn_fwd_any_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, a.st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), a.C, a.HW, HWv,
        total, a.size, coef, a.k, mode, a.beta, a.relu);
  }
  return (int)cudaGetLastError();
}

template <typename T, int SIZE>
int launch_vec(bool bwd, const void* g, const void* x, void* out,
               const Args& a) {
  const bool vec4 = a.HW % 4 == 0 && aligned<T>(x, 4) && aligned<T>(out, 4)
                    && (!bwd || aligned<T>(g, 4));
  if constexpr (SIZE == 0)
    return vec4 ? launch_any<T, 4>(bwd, g, x, out, a)
                : launch_any<T, 1>(bwd, g, x, out, a);
  else
    return vec4 ? launch<T, SIZE, 4>(bwd, g, x, out, a)
                : launch<T, SIZE, 1>(bwd, g, x, out, a);
}

template <typename T>
int launch_size(bool bwd, const void* g, const void* x, void* out,
                const Args& a) {
  switch (a.size) {
    case 1: return launch_vec<T, 1>(bwd, g, x, out, a);
    case 2: return launch_vec<T, 2>(bwd, g, x, out, a);
    case 3: return launch_vec<T, 3>(bwd, g, x, out, a);
    case 4: return launch_vec<T, 4>(bwd, g, x, out, a);
    case 5: return launch_vec<T, 5>(bwd, g, x, out, a);
    case 6: return launch_vec<T, 6>(bwd, g, x, out, a);
    case 7: return launch_vec<T, 7>(bwd, g, x, out, a);
    case 8: return launch_vec<T, 8>(bwd, g, x, out, a);
    case 9: return launch_vec<T, kMaxSize>(bwd, g, x, out, a);
    default: return a.size > kMaxSize ? launch_vec<T, 0>(bwd, g, x, out, a)
                                      : -3;
  }
}

int dispatch(int dtype, bool bwd, const void* g, const void* x, void* out,
             const Args& a) {
  if (dtype == 0) return launch_size<float>(bwd, g, x, out, a);
  if (dtype == 1) return launch_size<__nv_bfloat16>(bwd, g, x, out, a);
  return -2;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x, y: contiguous (N, C, H*W); any size
// >= 1. Returns 0, or a CUDA error code (negative: unsupported dtype /
// size / grid, or -5 for a backward past kMaxSize without its scratch).
extern "C" int bigdl_lrn_fwd(int dtype, const void* x, void* y, int N, int C,
                             int HW, int size, float alpha, float beta,
                             float k, int relu, void* stream) {
  Args a{N, C, HW, alpha, beta, k, size, relu, nullptr,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, false, nullptr, x, y, a);
}

// g, x, dx: contiguous (N, C, H*W) of one dtype; x is the pre-ReLU input.
// tbuf: past kMaxSize an f32 scratch of N*C*H*W elements, 16-byte
// aligned (unused, and may be null, up to it)
extern "C" int bigdl_lrn_bwd(int dtype, const void* g, const void* x,
                             void* dx, float* tbuf, int N, int C, int HW,
                             int size, float alpha, float beta, float k,
                             int relu, void* stream) {
  Args a{N, C, HW, alpha, beta, k, size, relu, tbuf,
         static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, true, g, x, dx, a);
}

// Cross-map local response normalisation for Hopper (sm_90a): forward and
// analytic backward over the channels of an NCHW activation.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (line 121) and
// `_bwd_kernel` (line 129) launched by `lrn` through `_call` in
// bigdl_tpu/ops/pallas/lrn.py (the pl.pallas_call at line 150). It
// computes the same function:
//
//   r   = x, or max(x, 0) with relu
//   s_c = k + alpha/n * sum_{j in win(c)} r_j^2,  win(c) = [c-lo, c+hi],
//         lo = (n-1)/2, hi = n-1-lo
//   y_c = r_c * s_c^-beta
//   dx_c = g_c*s_c^-beta - (2*alpha*beta/n) * r_c * sum_{j in adj(c)} t_j,
//         t_j = g_j*r_j*s_j^-beta / s_j,  adj(c) = [c-hi, c+lo]
//         (masked by x_c > 0 with relu)
//
// Not the TPU's layout: the (H*W, C, N) view and the banded (C, C) window
// matmul exist for the TPU's lanes and MXU; here the activation stays
// NCHW as cuDNN writes it, and each window sum is taken afresh in channel
// order (as the plain versions do), never as a running add/subtract sum,
// whose rounding would drift across the channels. All arithmetic is f32;
// inputs and outputs keep the activation dtype.
//
// Forward (`lrn_fwd_kernel`, `lrn_fwd_any_kernel`). One thread per (n,
// VEC positions of h*w) walks the C channels in order, so adjacent
// threads read adjacent h*w of one channel plane: every read and write is
// coalesced. VEC = 4 where H*W and the pointers allow, else 1. Up to
// kMaxSize (9) the window lives in a register ring of n f32 values per
// position (the window size a template parameter); past it the window is
// a runtime value and each window sum is read again from L1/L2.
//
// Backward: two routes, picked by `route_of` (mirrored by
// ops.lrn.bwd_route; the C entry reports the route it took):
// - "staged" (`lrn_bwd_staged_kernel<T, SIZE, ALIGNED>`): every window up
//   to kMaxSize (SIZE 1..9, a template parameter), and past it (SIZE 0,
//   the window a runtime value) every window whose slots min(size, C) are
//   at most kAnyMaxSlots (256: at C <= 256 every window).
// - "any" (`lrn_bwd_any_kernel`): past that cap. It walks each channel
//   column twice, parking t in an f32 scratch as large as x that the
//   wrapper allocates on this route only.
//
// The staged backward. A CTA takes image n and a run of P consecutive
// positions of its H*W plane (runs never cross images; P a multiple of 16
// bytes, at most kRowBytes: 448 bf16 or 224 f32, the runs of a plane as
// even as that allows, so the last may end mid-plane) and walks all C
// channels in order.
// - Loads in flight, decoupled from the walk: warp 0 stages chunks of CC
//   channels (CC = the least multiple of the window >= kChunk: 10 at a
//   window of 5) of x and of g (g's rows hi channels behind x's, so a
//   step reads one stage) into a ring of kStages stages, on each stage's
//   full mbarrier; the consumers free a stage on its empty mbarrier.
//   Lane r of warp 0 copies row r of a chunk: its whole 16-byte chunks by
//   one bulk copy (`hopper::bulk_load`, expected on the mbarrier first),
//   all lanes at once (one thread issuing a chunk's 20 copies in turn was
//   the staging's limit). Where a row is no whole 16-byte chunks (H*W
//   odd, as AlexNet's 55x55 and 27x27, or a pointer off 16-byte
//   alignment), the lane copies its ends element by element and the row
//   sits in shared memory at its own 16-byte offset (ALIGNED false).
// - The walk, with no moves: each consumer thread owns 4 bytes of a row
//   (VEC = 2 bf16 or 1 f32 positions) and keeps rings of r, u = g*s^-beta
//   and t in registers, all of SIZE slots indexed by channel mod SIZE. The
//   chunk loop is unrolled by CC, a multiple of SIZE, so the slots rotate
//   by name and a step moves no value. Chunks whose steps all lie inside
//   [0, C) run unguarded; the first and the last (the C remainder, and the
//   SIZE-1 steps past C that finish the last outputs) run guarded, out of
//   range channels reading as zeros.
// - Runtime windows (SIZE 0): the same kernel keeps L = min(size, C)
//   slots of r and of t and min(lo + 1, L) of u a position in shared
//   memory (each thread its own columns, so no barrier), sized at launch.
//   Window sums skip out-of-range channels, so L slots suffice; each runs
//   over at most two spans of consecutive slots (`ring_sum`), not testing
//   for the wrap at every slot. Where a step's window and adjoint window
//   are whole, their first size - 1 terms are walked together, two
//   independent chains (`ring_sum2`), and the last, r_i^2 and t_j, come
//   from registers: the same sums in the same order. Its stages hold
//   kSlotChunk (4) channels (the walk, not the bytes, sets this form's
//   pace), and its run shrinks a warp's positions at a time until a CTA
//   fits kAnyCtaBytes (two CTAs an SM), down to kAnyRunMin (64)
//   positions, where the cap's 256 slots (kAnyMaxSlots) still fit a
//   block's shared memory.
// - Shorter arithmetic: s^-beta and s^-beta/s with no IEEE division or
//   square root (`pow_pair`): q = rsqrt(s) by the SFU, then beta 0.75:
//   s^-beta = q^2 * rsqrt(q), beta 0.5: q, beta 1: rcp(s); t_j = g_j *
//   r_j * (s^-beta * q^2) (s^-beta / s for other betas through rcp(s)).
//   dx is stored from registers, coalesced along the row.
//
// Bound on the H100: bytes. The forward reads x and writes y, the
// backward reads g and x and writes dx, each once: at norm2 of
// Inception-v1 ((256, 192, 56, 56), bf16) 0.2761 ms at 3.35 TB/s. Its
// operations, some 3n+10 f32 an element (0.0415 ms at the CUDA cores' 67
// TFLOP/s), sit far under that; the issue of some 30 instructions an
// element (loads, conversions, the two window sums, the SFU calls)
// comes closer, which is why the arithmetic takes the short routes.
// Measured (NVIDIA H100 80GB HBM3, 700 W, `scripts/lrn_ab.py --only
// knockout`), the register form at norm2 is bound by its bytes: staging
// x and g and storing dx = g alone takes 0.96x its time, at some 2.7
// TB/s of reads and writes; the runtime-window form by its walk.
// In flight: a stage at a window of 5 (bf16 P 448 or f32 P 224) is 2 x
// 10 x 912 = 18,240 bytes, a CTA's ring 54,720 (54,848 bytes of dynamic
// shared memory with the mbarriers); the producer runs up to kStages
// chunks ahead of the walk (36,480 bytes in flight beside the stage being
// walked), and four CTAs fit an SM (some 146 KB in flight an SM, where
// 3.35 TB/s needs about 25 KB at the card's latency). ptxas (sm_90a): at
// a window of 5, 60 registers a thread bf16 and 46 f32 (rows of whole
// chunks), 64 otherwise; past window 9, 64 bf16 and 40 f32 (64 / 48
// unaligned); no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// --- the staged backward ---

constexpr int kRowBytes = 896;  // a run's row of x or g: 448 bf16, 224 f32
constexpr int kConsumerWarps = (kRowBytes / 4 + 31) / 32;  // 4 bytes a thread
constexpr int kStagedThreads = 32 * (1 + kConsumerWarps);
constexpr int kStages = 3;      // the ring of staged chunks
constexpr int kChunk = 8;       // channels a stage holds, at least
constexpr int kBarBytes = 128;  // the full and empty mbarriers, padded
constexpr int kSmemMax = 232448;
constexpr int kAnyRunMin = 64;        // runtime window: the shortest run
constexpr int kAnyCtaBytes = 116224;  // runtime window: two CTAs an SM
constexpr int kSlotChunk = 4;   // runtime window: channels a stage holds
constexpr int kAnyMaxSlots = 256;  // runtime window: at most min(size, C)
constexpr int kRouteStaged = 0, kRouteAny = 1;

// channels a stage holds: the least multiple of the window >= kChunk (a
// whole number of ring turns), kSlotChunk past kMaxSize
__host__ __device__ constexpr int chunk_of(int size) {
  return size == 0 || size > kMaxSize
             ? kSlotChunk
             : size * ((kChunk + size - 1) / size);
}
// a staged row of P elements at its own 16-byte offset
constexpr int row_bytes(int P, int elt) {
  return (P * elt + 16 - elt + 15) / 16 * 16;
}
// consumer threads of a run of P positions, 4 bytes each, whole warps
constexpr int consumers_of(int P, int elt) {
  return (P * elt / 4 + 31) / 32 * 32;
}
// slots of u past kMaxSize: u of channels c .. j = c + lo
constexpr int u_slots(int size, int L) {
  return (size - 1) / 2 + 1 < L ? (size - 1) / 2 + 1 : L;
}
// dynamic shared memory of a CTA: mbarriers, the ring, past kMaxSize the
// L slots of r and t and the u_slots of u for each consumer's positions
constexpr int64_t staged_smem(int P, int elt, int size, int L) {
  return kBarBytes + (int64_t)kStages * 2 * chunk_of(size) * row_bytes(P, elt)
         + (size > kMaxSize ? (int64_t)(2 * L + u_slots(size, L))
                                  * consumers_of(P, elt) * (4 / elt) * 4
                            : 0);
}
static_assert(staged_smem(kAnyRunMin, 4, 2 * kAnyMaxSlots, kAnyMaxSlots)
                  <= kSmemMax, "the cap's slots fit the shortest f32 run");
static_assert(staged_smem(kAnyRunMin, 2, 2 * kAnyMaxSlots, kAnyMaxSlots)
                  <= kSmemMax, "the cap's slots fit the shortest bf16 run");

// the most positions a run may hold: kRowBytes; past kMaxSize shrunk a
// warp's positions at a time until the CTA fits kAnyCtaBytes, down to
// kAnyRunMin
int run_cap(int elt, int size, int L) {
  int cap = kRowBytes / elt;
  if (size <= kMaxSize) return cap;
  while (cap > kAnyRunMin && staged_smem(cap, elt, size, L) > kAnyCtaBytes)
    cap -= 32 * (4 / elt);
  return cap;
}
// positions a run holds: the plane cut in as few runs of at most cap as
// it takes, as even as multiples of 16 bytes allow
int64_t run_len(int64_t HW, int cap, int elt) {
  const int64_t runs = (HW + cap - 1) / cap, a = 16 / elt;
  return ((HW + runs - 1) / runs + a - 1) / a * a;
}

int route_of(int C, int size) {
  if (size <= kMaxSize) return kRouteStaged;
  return (size < C ? size : C) <= kAnyMaxSlots ? kRouteStaged : kRouteAny;
}

struct Walk {
  int C;
  int64_t HW;
  int P, runs, row_bytes, cols;  // cols: slot columns (consumers x VEC)
  int size, lo, hi, L, Lu;       // the window (SIZE 0: its slots)
  float coef, k, beta, coef2;
  int mode, relu;
};

// a row of bytes at device address a, cut at 16-byte boundaries: whole
// chunks [lo, hi) by bulk copy, [a, lo) and [hi, end) element by element;
// in shared memory the row keeps its 16-byte offset (at(u): where device
// byte u sits from the row's start)
struct RowSpan {
  uintptr_t a, lo, hi, end;
  __device__ __forceinline__ RowSpan(const void* p, int bytes) {
    a = (uintptr_t)p;
    end = a + (uintptr_t)bytes;
    lo = (a + 15) & ~(uintptr_t)15;
    hi = end & ~(uintptr_t)15;
    if (hi <= lo) lo = hi = end;  // no whole chunk: all element by element
  }
  __device__ __forceinline__ uint32_t bytes() const {
    return (uint32_t)(hi - lo);
  }
  __device__ __forceinline__ uint32_t at(uintptr_t u) const {
    return (uint32_t)(u - (a & ~(uintptr_t)15));
  }
};

// `bytes` more of bulk-copy traffic before the phase of mbarrier `bar`
// completes (no arrival)
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// the SFU's approximations, subnormal inputs flushed to zero (s >= k:
// only a subnormal k reaches them)
__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// b = s^-beta and bs = s^-beta / s with no IEEE division or square root
// (MODE 0: beta 0.75, 1: 0.5, 2: 1, 3: pow), q = rsqrt(s) so 1/s = q^2.
// A template parameter, so a walk's steps hold no branch on it
template <int MODE>
__device__ __forceinline__ void pow_pair(float s, float beta, float& b,
                                         float& bs) {
  if constexpr (MODE == 0) {
    const float q = rsqrt_approx(s), q2 = q * q;
    b = q2 * rsqrt_approx(q);
    bs = b * q2;
  } else if constexpr (MODE == 1) {
    const float q = rsqrt_approx(s);
    b = q;
    bs = q * q * q;
  } else if constexpr (MODE == 2) {
    b = rcp_approx(s);
    bs = b * b;
  } else {
    b = powf(s, -beta);
    bs = b * rcp_approx(s);
  }
}

// r of x: x, or max(x, 0) with relu, a NaN kept (as jnp.maximum)
__device__ __forceinline__ float relu_nan(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;\n" : "=f"(r) : "f"(v));
  return r;
}

// this thread's VEC values of a staged row at p (its column's bytes in),
// whose first element sits m bytes further (0 for ALIGNED rows: the row's
// 16-byte offset in device memory). A bf16 pair off 4-byte alignment is
// cut from the two words around it. Past the run's end (the last pair of
// an odd run) it reads the row's slack, which no store takes
template <typename T, int VEC, bool ALIGNED>
__device__ __forceinline__ void read_row(const unsigned char* p, int m,
                                         float (&v)[VEC]) {
  if (!ALIGNED) p += m;
  if constexpr (VEC == 2) {
    uint32_t w;
    if (ALIGNED || (m & 2) == 0) {
      w = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w = __byte_perm(*reinterpret_cast<const uint32_t*>(p - 2),
                      *reinterpret_cast<const uint32_t*>(p + 2), 0x5432);
    }
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    v[0] = to_f32(*reinterpret_cast<const T*>(p));
  }
}

// VEC values to dx's row at dst from column col of a run of len; md: the
// row's 16-byte offset in device memory (a bf16 pair goes as one 4-byte
// store where it is 4-byte aligned and whole)
template <typename T, int VEC, bool ALIGNED>
__device__ __forceinline__ void write_row(T* dst, int md, int col, int len,
                                          const float (&v)[VEC]) {
  if constexpr (VEC == 2) {
    if (ALIGNED || ((md & 2) == 0 && col + 1 < len)) {
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(v[0], v[1]);
    } else {
      dst[col] = from_f32<T>(v[0]);
      if (col + 1 < len) dst[col + 1] = from_f32<T>(v[1]);
    }
  } else {
    dst[col] = from_f32<T>(v[0]);
  }
}

// what a consumer thread walks with: its run, its column, the stage
struct Lane {
  const unsigned char* st;  // the stage of this chunk
  int64_t base;             // (n, first position of the run)
  int col, len;             // its column, the run's length
  int toff;                 // its column's bytes into a staged row
  bool active;              // col < len
  // unaligned rows: the 16-byte offsets of channel 0's row of x, g and dx
  // at the run, and how far each channel moves them (H*W bytes)
  int mx, mg, md, dm;
};

// the CC steps of chunk kc over register rings of SIZE slots (slot =
// channel mod SIZE, constant in each unrolled step). Step i reads x's
// channel i, completes the window of j = i - HI (its s, u and t) and
// writes dx of c = i - SIZE + 1, whose adjoint window [c-HI, c+LO] is the
// ring of t
template <bool GUARD, int SIZE, bool ALIGNED, int MODE, typename T,
          int VEC>
__device__ __forceinline__ void walk_regs(float (&R)[SIZE][VEC],
                                          float (&U)[SIZE][VEC],
                                          float (&Tt)[SIZE][VEC],
                                          T* __restrict__ dx, const Lane& l,
                                          int kc, const Walk& a) {
  constexpr int CC = chunk_of(SIZE), LO = (SIZE - 1) / 2, HI = SIZE - 1 - LO;
#pragma unroll
  for (int q = 0; q < CC; ++q) {
    const int i = kc * CC + q, j = i - HI, c = i - SIZE + 1;
    const int si = q % SIZE, sj = (q + SIZE - HI) % SIZE, sc = (q + 1) % SIZE;
    if (!GUARD || i < a.C) {
      read_row<T, VEC, ALIGNED>(l.st + q * a.row_bytes + l.toff,
                                (l.mx + i * l.dm) & 15, R[si]);
      if (a.relu) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) R[si][v] = relu_nan(R[si][v]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[si][v] = 0.0f;
    }
    if (!GUARD || (j >= 0 && j < a.C)) {
      float gv[VEC];
      read_row<T, VEC, ALIGNED>(l.st + (CC + q) * a.row_bytes + l.toff,
                                (l.mg + j * l.dm) & 15, gv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float sum = 0.0f;  // over win(j) = channels i-SIZE+1 .. i
#pragma unroll
        for (int m = 0; m < SIZE; ++m) {
          const float r = R[(q + 1 + m) % SIZE][v];
          sum = fmaf(r, r, sum);
        }
        float b, bs;
        pow_pair<MODE>(fmaf(a.coef, sum, a.k), a.beta, b, bs);
        U[sj][v] = gv[v] * b;
        Tt[sj][v] = gv[v] * R[sj][v] * bs;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) U[sj][v] = Tt[sj][v] = 0.0f;
    }
    if (!GUARD || (c >= 0 && c < a.C)) {
      float o[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float acc = 0.0f;  // over adj(c) = channels j-SIZE+1 .. j
#pragma unroll
        for (int m = 0; m < SIZE; ++m)
          acc += Tt[(q + SIZE - HI + 1 + m) % SIZE][v];
        const float r = R[sc][v];
        const float d = U[sc][v] - a.coef2 * r * acc;
        o[v] = (a.relu && !(r > 0.0f)) ? 0.0f : d;
      }
      if (l.active)
        write_row<T, VEC, ALIGNED>(dx + l.base + (int64_t)c * a.HW,
                                   l.md + c * l.dm, l.col, l.len, o);
    }
  }
}

// VEC floats of slot row s at this thread's column
template <int VEC>
__device__ __forceinline__ void ld_slot(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void st_slot(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// acc += the n slot rows of a ring of L rows (cols floats apart) from
// slot s on, in slot (channel) order, wrapping once at most: squares
// (SQUARE) or values; two runs of consecutive rows, so no step tests for
// the wrap
template <bool SQUARE, int VEC>
__device__ __forceinline__ void ring_sum(const float* ring, int cols, int L,
                                         int s, int n, float (&acc)[VEC]) {
  while (n > 0) {
    const int run = n < L - s ? n : L - s;
    const float* p = ring + s * cols;
#pragma unroll 8
    for (int m = 0; m < run; ++m, p += cols) {
      float v[VEC];
      ld_slot<VEC>(p, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] = SQUARE ? fmaf(v[e], v[e], acc[e]) : acc[e] + v[e];
    }
    n -= run;
    s = 0;
  }
}

// sq += the squares of n slot rows of ring R from slot a on, acc += n
// slot rows of ring Tr from slot b on, each in slot (channel) order, the
// two walked together (two independent chains); each wraps once at most
template <int VEC>
__device__ __forceinline__ void ring_sum2(const float* R, const float* Tr,
                                          int cols, int L, int a, int b,
                                          int n, float (&sq)[VEC],
                                          float (&acc)[VEC]) {
  while (n > 0) {
    int run = L - a < L - b ? L - a : L - b;
    if (run > n) run = n;
    const float* p = R + a * cols;
    const float* q = Tr + b * cols;
#pragma unroll 8
    for (int m = 0; m < run; ++m, p += cols, q += cols) {
      float v[VEC], w[VEC];
      ld_slot<VEC>(p, v);
      ld_slot<VEC>(q, w);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sq[e] = fmaf(v[e], v[e], sq[e]);
        acc[e] += w[e];
      }
    }
    n -= run;
    a = a + run == L ? 0 : a + run;
    b = b + run == L ? 0 : b + run;
  }
}

// the rest of a step of walk_slots where a window or its adjoint is cut
// by [0, C) (or min(size, C) < size): each sum over its in-range slots
template <typename T, int VEC, bool ALIGNED, int MODE>
__device__ __forceinline__ void walk_slot_edge(
    float* Rs, float* Us, float* Ts, int si, int sj, int sc, int uj, int uc,
    T* __restrict__ dx, const Lane& l, int q, int i, const Walk& a) {
  constexpr int CC = kSlotChunk;
  const int L = a.L, cols = a.cols;
  const int j = i - a.hi, c = i - a.size + 1;
  if (j >= 0 && j < a.C) {
    const int j0 = max(j - a.lo, 0), n = min(j + a.hi, a.C - 1) - j0 + 1;
    int s = sj - (j - j0);
    if (s < 0) s += L;
    float sum[VEC] = {};
    ring_sum<true>(Rs, cols, L, s, n, sum);
    float gv[VEC], rj[VEC], u[VEC], t[VEC];
    read_row<T, VEC, ALIGNED>(l.st + (CC + q) * a.row_bytes + l.toff,
                              (l.mg + j * l.dm) & 15, gv);
    ld_slot<VEC>(Rs + sj * cols, rj);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float b, bs;
      pow_pair<MODE>(fmaf(a.coef, sum[v], a.k), a.beta, b, bs);
      u[v] = gv[v] * b;
      t[v] = gv[v] * rj[v] * bs;
    }
    st_slot<VEC>(Us + uj * cols, u);
    st_slot<VEC>(Ts + sj * cols, t);
  }
  if (c >= 0 && c < a.C) {
    const int c0 = max(c - a.hi, 0), n = min(c + a.lo, a.C - 1) - c0 + 1;
    int s = sc - (c - c0);
    if (s < 0) s += L;
    float acc[VEC] = {};
    ring_sum<false>(Ts, cols, L, s, n, acc);
    float r[VEC], u[VEC], o[VEC];
    ld_slot<VEC>(Rs + sc * cols, r);
    ld_slot<VEC>(Us + uc * cols, u);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float d = u[v] - a.coef2 * r[v] * acc[v];
      o[v] = (a.relu && !(r[v] > 0.0f)) ? 0.0f : d;
    }
    if (l.active)
      write_row<T, VEC, ALIGNED>(dx + l.base + (int64_t)c * a.HW,
                                 l.md + c * l.dm, l.col, l.len, o);
  }
}

// the CC steps of chunk kc with the window a runtime value: the rings are
// L slots of r and of t in shared memory (this thread's column of each),
// slot = channel mod L; window sums run over the in-range channels only,
// in channel order, so no two of them share a slot. u keeps Lu = lo + 1
// slots (channels c .. j). si, sj, sc: the slots of channels i, j, c in
// the rings of r and t; uj, uc: of j and c in u's; carried from step to
// step
template <typename T, int VEC, bool ALIGNED, int MODE>
__device__ __forceinline__ void walk_slots(float* Rs, float* Us, float* Ts,
                                           int& si, int& sj, int& sc,
                                           int& uj, int& uc,
                                           T* __restrict__ dx, const Lane& l,
                                           int kc, const Walk& a) {
  constexpr int CC = kSlotChunk;
  const int L = a.L, Lu = a.Lu, cols = a.cols;
  auto next = [L](int s) { return s + 1 == L ? 0 : s + 1; };
  for (int q = 0; q < CC; ++q) {
    const int i = kc * CC + q, j = i - a.hi, c = i - a.size + 1;
    float ri[VEC];  // r of channel i
    if (i < a.C) {
      read_row<T, VEC, ALIGNED>(l.st + q * a.row_bytes + l.toff,
                                (l.mx + i * l.dm) & 15, ri);
      if (a.relu) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) ri[v] = relu_nan(ri[v]);
      }
      st_slot<VEC>(Rs + si * cols, ri);
    }
    if (i < a.C && c >= a.hi && L == a.size) {
      // a step whose window and adjoint window are whole: their first
      // size - 1 terms walked together (two chains), the last ones, r_i^2
      // and t_j, from registers; the same sums, in the same order, as
      // walk_slot_edge's
      float sum[VEC] = {}, acc[VEC] = {};
      ring_sum2(Rs, Ts, cols, L, next(si), next(sj), L - 1, sum, acc);
      float gv[VEC], rj[VEC], rc[VEC], ucv[VEC], u[VEC], t[VEC], o[VEC];
      read_row<T, VEC, ALIGNED>(l.st + (CC + q) * a.row_bytes + l.toff,
                                (l.mg + j * l.dm) & 15, gv);
      ld_slot<VEC>(Rs + sj * cols, rj);
      ld_slot<VEC>(Rs + sc * cols, rc);
      ld_slot<VEC>(Us + uc * cols, ucv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float b, bs;
        pow_pair<MODE>(fmaf(a.coef, fmaf(ri[v], ri[v], sum[v]), a.k), a.beta,
                       b, bs);
        u[v] = gv[v] * b;
        t[v] = gv[v] * rj[v] * bs;
        const float d = ucv[v] - a.coef2 * rc[v] * (acc[v] + t[v]);
        o[v] = (a.relu && !(rc[v] > 0.0f)) ? 0.0f : d;
      }
      st_slot<VEC>(Us + uj * cols, u);
      st_slot<VEC>(Ts + sj * cols, t);
      if (l.active)
        write_row<T, VEC, ALIGNED>(dx + l.base + (int64_t)c * a.HW,
                                   l.md + c * l.dm, l.col, l.len, o);
    } else {
      walk_slot_edge<T, VEC, ALIGNED, MODE>(Rs, Us, Ts, si, sj, sc, uj, uc,
                                            dx, l, q, i, a);
    }
    si = next(si);
    sj = next(sj);
    sc = next(sc);
    uj = uj + 1 == Lu ? 0 : uj + 1;
    uc = uc + 1 == Lu ? 0 : uc + 1;
  }
}

// the ring as a consumer sees it
struct Ring {
  unsigned char* stages;
  int stage_bytes;
  uint32_t full, empty;  // the stages' mbarriers
  int loads, chunks;     // chunks with staged rows; chunks of steps
  int lane;
};

// a consumer thread's walk over all chunks, at beta's MODE
template <int MODE, int SIZE, bool ALIGNED, typename T>
__device__ __forceinline__ void consume(T* __restrict__ dx, Lane l,
                                        const Ring& r, const Walk& a) {
  constexpr int CC = chunk_of(SIZE), VEC = 4 / sizeof(T);
  [[maybe_unused]] float R[SIZE ? SIZE : 1][VEC], U[SIZE ? SIZE : 1][VEC],
      Tt[SIZE ? SIZE : 1][VEC];
  float *Rs = nullptr, *Us = nullptr, *Ts = nullptr;
  int si = 0, sj = 0, sc = 0, uj = 0, uc = 0;
  if constexpr (SIZE != 0) {
#pragma unroll
    for (int m = 0; m < SIZE; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) R[m][v] = U[m][v] = Tt[m][v] = 0.0f;
  } else {
    Rs = reinterpret_cast<float*>(r.stages + (size_t)kStages * r.stage_bytes)
         + l.col;
    Ts = Rs + (size_t)a.L * a.cols;
    Us = Ts + (size_t)a.L * a.cols;
    sj = ((-a.hi) % a.L + a.L) % a.L;
    sc = ((1 - a.size) % a.L + a.L) % a.L;
    uj = ((-a.hi) % a.Lu + a.Lu) % a.Lu;
    uc = ((1 - a.size) % a.Lu + a.Lu) % a.Lu;
  }
  for (int kc = 0; kc < r.chunks; ++kc) {
    const int s = kc % kStages;
    const bool staged = kc < r.loads;
    if (staged) hopper::bar_wait(r.full + 8 * s, (kc / kStages) & 1);
    l.st = r.stages + (size_t)s * r.stage_bytes;
    if constexpr (SIZE != 0) {
      if (kc * CC < SIZE - 1 || (kc + 1) * CC > a.C)
        walk_regs<true, SIZE, ALIGNED, MODE>(R, U, Tt, dx, l, kc, a);
      else
        walk_regs<false, SIZE, ALIGNED, MODE>(R, U, Tt, dx, l, kc, a);
    } else {
      walk_slots<T, VEC, ALIGNED, MODE>(Rs, Us, Ts, si, sj, sc, uj, uc, dx,
                                        l, kc, a);
    }
    if (staged) {
      __syncwarp();
      if (r.lane == 0) hopper::bar_arrive(r.empty + 8 * s);
    }
  }
}

// The staged backward: warp 0 stages chunks of x and g rows into the
// ring, lane r row r, by bulk copy; warps 1.. walk the channels (SIZE
// 1..9: register rings; SIZE 0: the window a runtime value, slots in
// shared memory). ALIGNED: rows of whole 16-byte chunks, no ends to copy
template <typename T, int SIZE, bool ALIGNED>
__global__ void __launch_bounds__(kStagedThreads)
    lrn_bwd_staged_kernel(const T* __restrict__ g, const T* __restrict__ x,
                          T* __restrict__ dx, Walk a) {
  constexpr int CC = chunk_of(SIZE), VEC = 4 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = hopper::smem_u32(smem), empty = full + 8 * kStages;
  unsigned char* stages = smem + kBarBytes;
  const int region = CC * a.row_bytes;  // a stage's x rows, then g's
  const int64_t p0 = (int64_t)(blockIdx.x % a.runs) * a.P;
  const int64_t rest = a.HW - p0;
  const int len = (int)(rest < a.P ? rest : a.P);
  const int64_t base = (int64_t)(blockIdx.x / a.runs) * a.C * a.HW + p0;
  const int hi = SIZE ? (SIZE - 1) - (SIZE - 1) / 2 : a.hi;
  const int size = SIZE ? SIZE : a.size;
  const int loads = (a.C + hi + CC - 1) / CC;        // chunks with rows
  const int chunks = (a.C + size - 1 + CC - 1) / CC;  // chunks of steps
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::bar_init(full + 8 * s, 32);
      hopper::bar_init(empty + 8 * s, blockDim.x / 32 - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    const int bytes = len * (int)sizeof(T);
    for (int kc = 0; kc < loads; ++kc) {
      const int s = kc % kStages;
      if (kc >= kStages)
        hopper::bar_wait(empty + 8 * s, (kc / kStages - 1) & 1);
      const uint32_t bar = full + 8 * s;
      unsigned char* st = stages + (size_t)s * 2 * region;
      // x's rows kc*CC.., then g's hi channels behind
      for (int t = 0; t < 2; ++t) {
        const int first = kc * CC - (t ? hi : 0);
        // lane r: row r (in [0, C)): its whole 16-byte chunks by one bulk
        // copy (expected on the stage's mbarrier first), its ends element
        // by element
        for (int r = lane; r < CC; r += 32) {
          const int ch = first + r;
          if (ch < 0 || ch >= a.C) continue;
          const RowSpan sp((t ? g : x) + base + (int64_t)ch * a.HW, bytes);
          unsigned char* to = st + t * region + r * a.row_bytes;
          if (sp.bytes()) {
            expect_tx(bar, sp.bytes());
            hopper::bulk_load(hopper::smem_u32(to + sp.at(sp.lo)),
                              (const void*)sp.lo, sp.bytes(), bar);
          }
          if constexpr (!ALIGNED) {
            for (uintptr_t u = sp.a; u < sp.lo; u += sizeof(T))
              *reinterpret_cast<T*>(to + sp.at(u)) =
                  *reinterpret_cast<const T*>(u);
            for (uintptr_t u = sp.hi; u < sp.end; u += sizeof(T))
              *reinterpret_cast<T*>(to + sp.at(u)) =
                  *reinterpret_cast<const T*>(u);
          }
        }
      }
      hopper::bar_arrive(bar);  // one of 32
    }
    return;
  }

  Lane l;
  l.st = stages;
  l.base = base;
  l.len = len;
  l.col = (threadIdx.x - 32) * VEC;
  l.active = l.col < len;
  l.toff = (l.active ? l.col : 0) * (int)sizeof(T);  // idle: column 0
  l.mx = (int)((uintptr_t)(x + base) & 15);
  l.mg = (int)((uintptr_t)(g + base) & 15);
  l.md = (int)((uintptr_t)(dx + base) & 15);
  l.dm = (int)((a.HW * (int64_t)sizeof(T)) & 15);
  const Ring ring{stages, 2 * region, full, empty, loads, chunks, lane};
  switch (a.mode) {
    case 0: consume<0, SIZE, ALIGNED>(dx, l, ring, a); break;
    case 1: consume<1, SIZE, ALIGNED>(dx, l, ring, a); break;
    case 2: consume<2, SIZE, ALIGNED>(dx, l, ring, a); break;
    default: consume<3, SIZE, ALIGNED>(dx, l, ring, a); break;
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
  float* tbuf;       // the "any" backward's t scratch
  cudaStream_t st;
};

template <typename T, int SIZE, int VEC>
int launch(const void* x, void* out, const Args& a) {
  const int64_t HWv = a.HW / VEC;
  const int64_t total = (int64_t)a.N * HWv;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return -4;
  const float coef = a.alpha / a.size;
  const int mode = beta_mode(a.beta);
  lrn_fwd_kernel<T, SIZE, VEC><<<(unsigned)blocks, kThreads, 0, a.st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), a.C, a.HW, HWv,
      total, coef, a.k, mode, a.beta, a.relu);
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
    return vec4 ? launch<T, SIZE, 4>(x, out, a) : launch<T, SIZE, 1>(x, out, a);
}

template <typename T>
int launch_fwd(const void* x, void* y, const Args& a) {
  switch (a.size) {
    case 1: return launch_vec<T, 1>(false, nullptr, x, y, a);
    case 2: return launch_vec<T, 2>(false, nullptr, x, y, a);
    case 3: return launch_vec<T, 3>(false, nullptr, x, y, a);
    case 4: return launch_vec<T, 4>(false, nullptr, x, y, a);
    case 5: return launch_vec<T, 5>(false, nullptr, x, y, a);
    case 6: return launch_vec<T, 6>(false, nullptr, x, y, a);
    case 7: return launch_vec<T, 7>(false, nullptr, x, y, a);
    case 8: return launch_vec<T, 8>(false, nullptr, x, y, a);
    case 9: return launch_vec<T, kMaxSize>(false, nullptr, x, y, a);
    default: return a.size > kMaxSize ? launch_vec<T, 0>(false, nullptr, x,
                                                         y, a)
                                      : -3;
  }
}

// the staged backward at window SIZE (0: a runtime window within the cap)
template <typename T, int SIZE>
int launch_staged(const void* g, const void* x, void* dx, const Args& a) {
  constexpr int elt = sizeof(T);
  const int L = SIZE ? SIZE : (a.size < a.C ? a.size : a.C);
  const int P = (int)run_len(a.HW, run_cap(elt, a.size, L), elt);
  const int64_t runs = (a.HW + P - 1) / P, blocks = (int64_t)a.N * runs;
  if (blocks > 0x7fffffff) return -4;
  const int lo = (a.size - 1) / 2;
  const Walk w{a.C, a.HW, P, (int)runs, row_bytes(P, elt),
               consumers_of(P, elt) * (4 / elt), a.size, lo,
               a.size - 1 - lo, L, u_slots(a.size, L), a.alpha / a.size,
               a.k, a.beta, 2.0f * a.alpha * a.beta / a.size,
               beta_mode(a.beta), a.relu};
  const int64_t smem = staged_smem(P, elt, a.size, L);
  const bool whole = a.HW * elt % 16 == 0 && aligned<T>(g, 16 / elt)
                     && aligned<T>(x, 16 / elt) && aligned<T>(dx, 16 / elt);
  auto kernel = whole ? lrn_bwd_staged_kernel<T, SIZE, true>
                      : lrn_bwd_staged_kernel<T, SIZE, false>;
  const int err = hopper::set_smem(kernel, (size_t)smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, 32 + consumers_of(P, elt), (size_t)smem,
           a.st>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                   static_cast<T*>(dx), w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(int route, const void* g, const void* x, void* dx,
               const Args& a) {
  if (route == kRouteAny) return launch_vec<T, 0>(true, g, x, dx, a);
  switch (a.size) {
    case 1: return launch_staged<T, 1>(g, x, dx, a);
    case 2: return launch_staged<T, 2>(g, x, dx, a);
    case 3: return launch_staged<T, 3>(g, x, dx, a);
    case 4: return launch_staged<T, 4>(g, x, dx, a);
    case 5: return launch_staged<T, 5>(g, x, dx, a);
    case 6: return launch_staged<T, 6>(g, x, dx, a);
    case 7: return launch_staged<T, 7>(g, x, dx, a);
    case 8: return launch_staged<T, 8>(g, x, dx, a);
    case 9: return launch_staged<T, kMaxSize>(g, x, dx, a);
    default: return launch_staged<T, 0>(g, x, dx, a);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x, y: contiguous (N, C, H*W); any size
// >= 1. Returns 0, or a CUDA error code (negative: unsupported dtype /
// size / grid).
extern "C" int bigdl_lrn_fwd(int dtype, const void* x, void* y, int N, int C,
                             int HW, int size, float alpha, float beta,
                             float k, int relu, void* stream) {
  Args a{N, C, HW, alpha, beta, k, size, relu, nullptr,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_fwd<float>(x, y, a);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, y, a);
  return -2;
}

// g, x, dx: contiguous (N, C, H*W) of one dtype; x is the pre-ReLU input;
// any size >= 1. tbuf: on the "any" route an f32 scratch of N*C*H*W
// elements, 16-byte aligned (unused, and may be null, on "staged").
// *route (when not null): the route taken, 0 "staged", 1 "any"
// (route_of). Returns 0, or a CUDA error code (negative: unsupported dtype
// / size / grid, or -5 for the "any" route without its scratch).
extern "C" int bigdl_lrn_bwd(int dtype, const void* g, const void* x,
                             void* dx, float* tbuf, int N, int C, int HW,
                             int size, float alpha, float beta, float k,
                             int relu, void* stream, int* route) {
  Args a{N, C, HW, alpha, beta, k, size, relu, tbuf,
         static_cast<cudaStream_t>(stream)};
  if (dtype != 0 && dtype != 1) return -2;
  if (size < 1) return -3;
  const int r = route_of(C, size);
  if (route != nullptr) *route = r;
  return dtype == 0 ? launch_bwd<float>(r, g, x, dx, a)
                    : launch_bwd<__nv_bfloat16>(r, g, x, dx, a);
}

// Cross-map local response normalisation for Hopper (sm_90a): forward and
// analytic backward over the channels of an NCHW activation.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (line 121) and
// `_bwd_kernel` (line 129) launched by `lrn` through `_call` in
// bigdl_tpu/ops/pallas/lrn.py (the pl.pallas_call at line 150):
// `_fwd_kernel` by `lrn_fwd_kernel` (windows 1-9) and the tiled walk's
// `lrn_tiled_kernel` (past 9); `_bwd_kernel` by `lrn_bwd_staged_kernel`
// (route "staged") and, past its cap, the tiled walk's
// `lrn_bwd_tiled_kernel` (route "any"; past its own cap two launches of
// `lrn_tiled_kernel`). They compute the same function:
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
// Forward up to kMaxSize (`lrn_fwd_kernel`). One thread per (n, VEC
// positions of h*w) walks the C channels in order, so adjacent threads
// read adjacent h*w of one channel plane: every read and write is
// coalesced. VEC = 4 where H*W and the pointers allow, else 1. The window
// lives in a register ring of n f32 values per position (the window size
// a template parameter).
//
// Backward: two routes, picked by `route_of` (mirrored by
// ops.lrn.bwd_route; the C entry reports the route it took):
// - "staged" (`lrn_bwd_staged_kernel<T, SIZE, ALIGNED>`): every window up
//   to kMaxSize (SIZE 1..9, a template parameter), and past it (SIZE 0,
//   the window a runtime value) every window whose slots min(size, C) are
//   at most kAnyMaxSlots (256: at C <= 256 every window).
// - "any": past that cap, the tiled walk's backward (below).
//
// The tiled walk: the forward past kMaxSize and the "any" backward.
// - Work unit. A CTA takes image n, a run of P = 32*VEC*W consecutive
//   positions of its plane (VEC: 4 bytes of the dtype a thread; W warps
//   along the run: kWalkWarps 2, or 1 where the grid would hold fewer
//   than kWalkMinCtas 528 CTAs; runs never cross images, the last may end
//   mid-plane) and a tile of CT = kWalkTile 64 consecutive output
//   channels (fewer where C is): 2400 units at (32, 192, 56, 56) bf16
//   (P 128), 520 at (8, 320, 28, 28) bf16 (P 64).
// - Staging. Its span, the rows its windows cover, [c0 - lo, c0 + CT - 1
//   + hi] clipped to [0, C), lands in shared memory from warp 0: chunks of
//   kWalkChunk 16 rows, each on its own full mbarrier, lane r copying row
//   r of a chunk by one bulk copy (`hopper::bulk_load`), the ends of rows
//   that are no whole 16-byte chunks element by element at the row's own
//   16-byte offset (ALIGNED false), as the staged backward's warp 0. A
//   group starts on its first chunks while the rest are in flight.
//   Where two spans fit kWalkCtaBytes (116,224 bytes), the CTAs are
//   persistent (as many as fit the card, `lrn_tiled_kernel` bounded to
//   two an SM: 56 registers a thread) and walk units blockIdx.x, +
//   gridDim.x, ...: warp 0 stages the next unit's span into the second
//   buffer while the consumers walk this one, each buffer freed on an
//   empty mbarrier once every consumer warp is done with it (a group past
//   C waits for the span first, or it would free the buffer's next use
//   before that was staged). Past that a CTA takes one unit; where even
//   one span does not fit, its chunks go round a ring of S slots in
//   channel order, each freed once every consumer warp has walked it (the
//   lockstep ring; the forward's r then comes from device memory).
// - Register-blocked window sums, still in channel order. Consumer warp w
//   is group w / W: M = kWalkM 8 consecutive output channels at its 32
//   VEC-wide columns, a warp along one row (its reads one row, no bank
//   conflict). A thread holds M x VEC accumulators and reads each row of
//   its group's span once, adding r_j^2 (an fma) into each accumulator
//   whose window holds j: each sum starts at its own first in-range term
//   and runs in channel order, the same sum in the same order as the
//   plain order's (never a running add/subtract sum). Every window past
//   kMaxSize is at least M wide, so the span's first M - 1 rows (row h
//   taken by accumulators 0..h) and last M - 1 (row h by h..M-1) are
//   unrolled with no test; the rows between are in every window. At
//   window 288 a thread reads (288 + M - 1) / M = 37 rows an output from
//   shared memory where the runtime-window forward loaded 288 from L1/L2.
//   A ring walks each chunk's rows with the accumulators tested
//   (`walk_rows`).
// - Forward (`lrn_tiled_kernel`, kind kKindFwd): s = k + coef*sum (an
//   fma), y = r * s^-beta as `pow_neg_beta`: bit-equal to the
//   runtime-window forward it replaced, `lrn_fwd_any_kernel`
//   (`scripts/lrn_ab.py kernels`). A whole group's epilogue has beta's
//   mode fixed and no early exit, so its channels' chains interleave.
// - "any" backward, one launch (`lrn_bwd_tiled_kernel`): runs of P =
//   32*VEC, CT the widest multiple of M up to all of C whose x span, f32
//   t rows and f32 u rows fit a block's 232,448 bytes (`bwd_plan`; at
//   window 288 over C 320 all of C: a halo covering C would have every
//   tile redo all of s). Phase A: t-groups of M channels covering
//   [c0 - hi, c0 + CT - 1 + lo] (neighbouring tiles recompute this
//   halo), looped over up to kWalkGroups 16 consumer warps: s over the
//   staged x rows, t = g*r*s^-beta/s into the t rows and, for the tile's
//   own channels, u = g*s^-beta into the u rows (`pow_pair`; g read from
//   device memory before each group's walk). A named barrier over the
//   consumers. Phase B: the same walk over the t rows with the mirrored
//   window, dx = u - (2*alpha*beta/n)*r*sum (one fma), masked by x > 0
//   under relu, stored from registers.
// - Past that cap (no tile fits: the halo rows alone pass shared memory,
//   as at window 1500 over 2048 channels) the backward is two launches of
//   `lrn_tiled_kernel` through an f32 scratch of 2*N*C*H*W elements (t,
//   then u) that the wrapper allocates only there (ops.lrn.any_scratch):
//   kind kKindT writes t and u, kind kKindDx stages t rows and walks them
//   with the mirrored window; each may run the ring.
// - Bound on the H100. At window 288, (8, 320, 28, 28) bf16: operations,
//   2n + 6 f32 an element forward (1.17 GFLOP, 0.0174 ms at the CUDA
//   cores' 67 TFLOP/s) and 3n + 10 backward (1.75 GFLOP, 0.0262 ms); its
//   bytes, 8.0 MB forward even with each of the five tiles' spans
//   re-reading all 320 rows of x (24 MB, 0.0072 ms at 3.35 TB/s), sit
//   under that. At window 11, (32, 192, 56, 56) bf16: bytes, x read and
//   y written once 77.1 MB (0.0230 ms); the three tiles' spans of 69, 74
//   and 69 rows re-read 20 halo rows of each run's 192, 81.0 MB (0.0242
//   ms) where no halo row is found in L2.
// - Measured (NVIDIA H100 80GB HBM3, 700 W, `scripts/lrn_ab.py`, PERF.md
//   §6): at window 11 the walk, not the bytes, sets the pace (staging
//   nothing saves a quarter, the powers a sixth, the stores nothing);
//   register count decides how many 544-thread CTAs share an SM, which
//   moved the time more than any other setting.
// - ptxas (sm_90a): `lrn_tiled_kernel` 56 registers a thread, the bound
//   of two 544-thread CTAs an SM (unbounded, ptxas gave the bf16 forward
//   87: one CTA an SM, 1.2-1.5x slower), spilling 60 bytes in the bf16
//   forward (96 unaligned, 56-352 in the scratch passes); the one-launch
//   `lrn_bwd_tiled_kernel` 83 bf16 and 76-78 f32, no spill. Dynamic shared
//   memory (`walk_plan`, `bwd_plan`): at window 11 bf16 43,776 bytes a
//   CTA (two buffers of 5 chunks of 16 rows of 272 bytes); at window 288
//   92,800 forward and 210,304 bf16 / 128,384 f32 for the one-launch
//   backward (x span, t and u rows of all 320 channels).
// - Build: nvcc takes 126.4 s for this file against 98.4 s for its form
//   before the tiled walk (`scripts/lrn_ab.py --only build`, turns of
//   two on the card's host): the tiled kernels' 12 instantiations, each
//   with a forward epilogue at four fixed modes and one read at run
//   time, and the ring's tested walk beside the unrolled one.
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
// Bound on the H100 up to window 9 and the staged route's cap: bytes. The
// forward reads x and writes y, the backward reads g and x and writes dx,
// each once: at norm2 of Inception-v1 ((256, 192, 56, 56), bf16) 0.2761
// ms at 3.35 TB/s. Its
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

// --- the tiled walk: the forward past kMaxSize, the "any" backward ---

constexpr int kWalkM = 8;          // output channels a thread sums (M)
constexpr int kWalkTile = 64;      // output channels a unit (CT; the
                                   // one-launch backward sizes its own)
constexpr int kWalkWarps = 2;      // warps along a run, at most (W)
constexpr int kWalkMinCtas = 528;  // fewer units than this: one warp a run
constexpr int kWalkChunk = 16;     // staged rows an mbarrier covers (K)
constexpr int kWalkGroups = 16;    // the backward's consumer warps, at most
constexpr int kWalkCtaBytes = 116224;  // two spans past this: one a CTA;
                                       // one past it: a ring of chunks
constexpr int kWalkThreads = 32 * (1 + kWalkGroups);
constexpr int kKindFwd = 0, kKindT = 1, kKindDx = 2;
static_assert(kWalkTile / kWalkM * kWalkWarps <= kWalkGroups,
              "a forward CTA fits the launch bound");
static_assert(kWalkChunk <= 32, "a lane copies a row of a chunk");
static_assert(kWalkM <= kMaxSize + 1,
              "every window past kMaxSize holds a group's M channels");

// the mbarriers of S chunks (a full and an empty one each), padded
__host__ __device__ constexpr int walk_bar_bytes(int S) {
  return (16 * S + 127) / 128 * 128;
}

struct Tiled {
  int C;
  int64_t HW;
  int P, W, runs, tiles, CT;  // a run, warps along it, tiles of CT channels
  int rb;                     // bytes a staged row
  int a, b;                   // the walked window [c - a, c + b]
  int S;                      // chunk slots of a buffer (a ring when a
                              // span has more)
  int bufs;                   // 2: persistent CTAs, a span staged into
                              // one buffer while the other is walked
  int64_t units;              // (image, run, tile) units
  int lo, hi;                 // the window
  float coef, k, beta, coef2;
  int mode, relu;
};

// s^-beta and s^-beta / s at beta's mode, chosen at run time (once an
// output group, after its window sums)
__device__ __forceinline__ void pow_pair_rt(int mode, float s, float beta,
                                            float& b, float& bs) {
  switch (mode) {
    case 0: pow_pair<0>(s, beta, b, bs); break;
    case 1: pow_pair<1>(s, beta, b, bs); break;
    case 2: pow_pair<2>(s, beta, b, bs); break;
    default: pow_pair<3>(s, beta, b, bs); break;
  }
}

// beta's mode as a type: 0..3 fixed, -1 read at run time
template <int V> struct Mode {
  static constexpr int value = V;
};
// pow_neg_beta and pow_pair at a mode fixed at compile time (MODE >= 0:
// the same expressions as theirs) or read at run time (-1)
template <int MODE>
__device__ __forceinline__ float pow_neg_beta_at(float s, int mode,
                                                 float beta) {
  if constexpr (MODE < 0) {
    return pow_neg_beta(s, mode, beta);
  } else if constexpr (MODE == 0) {
    float r = rsqrtf(s);
    return r * sqrtf(r);
  } else if constexpr (MODE == 1) {
    return rsqrtf(s);
  } else if constexpr (MODE == 2) {
    return 1.0f / s;
  } else {
    return powf(s, -beta);
  }
}
template <int MODE>
__device__ __forceinline__ void pow_pair_at(float s, int mode, float beta,
                                            float& b, float& bs) {
  if constexpr (MODE < 0)
    pow_pair_rt(mode, s, beta, b, bs);
  else
    pow_pair<MODE>(s, beta, b, bs);
}

// this thread's VEC values of a staged row (as read_row; f32 rows of an
// activation in bf16 hold VEC 2 floats a thread)
template <typename S, int VEC, bool ALIGNED>
__device__ __forceinline__ void read_staged(const unsigned char* p, int m,
                                            float (&v)[VEC]) {
  if constexpr (sizeof(S) == 4 && VEC == 2) {
    if (!ALIGNED) p += m;
    if (ALIGNED || (m & 4) == 0) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      v[0] = f.x;
      v[1] = f.y;
    } else {
      v[0] = *reinterpret_cast<const float*>(p);
      v[1] = *reinterpret_cast<const float*>(p + 4);
    }
  } else {
    read_row<S, VEC, ALIGNED>(p, m, v);
  }
}

// a staged row for a window sum: as read_staged, its values first raised
// to `floor` by max.NaN (floor 0 under relu, -inf otherwise: no change),
// a bf16 pair in one instruction. Their squares are the plain order's
// (max(-0, 0) squares as -0 does, a NaN stays NaN); the epilogue's r keeps
// the exact `r < 0 ? 0 : r`
template <typename S, int VEC, bool ALIGNED>
__device__ __forceinline__ void read_sq_row(const unsigned char* p, int m,
                                            uint32_t floor, float (&v)[VEC]) {
  if constexpr (sizeof(S) == 2) {
    if (!ALIGNED) p += m;
    uint32_t w;
    if (ALIGNED || (m & 2) == 0) {
      w = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w = __byte_perm(*reinterpret_cast<const uint32_t*>(p - 2),
                      *reinterpret_cast<const uint32_t*>(p + 2), 0x5432);
    }
    asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(w) : "r"(w), "r"(floor));
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    read_staged<S, VEC, ALIGNED>(p, m, v);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      asm("max.NaN.f32 %0, %1, %2;\n"
          : "=f"(v[u]) : "f"(v[u]), "f"(__uint_as_float(floor)));
  }
}
// the floor of read_sq_row: 0 under relu, else -inf (a bf16 pair's, or
// an f32's)
template <typename S>
__host__ __device__ constexpr uint32_t sq_floor(int relu) {
  return relu ? 0u : sizeof(S) == 2 ? 0xff80ff80u : 0xff800000u;
}

// VEC values of a device row from column col of a run of len (zeros
// past it)
template <typename S, int VEC, bool ALIGNED>
__device__ __forceinline__ void load_cols(const S* __restrict__ row, int col,
                                          int len, float (&v)[VEC]) {
  if (ALIGNED && col + VEC <= len) {
    load_vec<S, VEC>(row + col, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = col + e < len ? to_f32(row[col + e]) : 0.0f;
  }
}
template <int VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int col,
                                           int len, const float (&v)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (col + e < len) row[col + e] = v[e];
}

// acc[m] += the squares (SQ) or values of the rows j in [j, e] that the
// window [cb + m - a, cb + m + b] of accumulator m holds, each in channel
// order. p: row j's staged bytes at this thread's column, rows rb bytes
// apart; m0: row j's 16-byte offset in device memory, moving dm a row.
// Rows in [mid0, mid1] are in every window: no test
template <bool SQ, bool RELU, typename S, int VEC, bool ALIGNED>
__device__ __forceinline__ void walk_rows(float (&acc)[kWalkM][VEC],
                                          const unsigned char* p, int rb,
                                          int m0, int dm, int j, int e,
                                          int cb, int a, int b, int mid0,
                                          int mid1) {
  auto take = [&](float (&v)[VEC], int jj) {
    read_staged<S, VEC, ALIGNED>(p, m0 & 15, v);
    if (RELU) relu_if(v, 1);
    p += rb;
    m0 += dm;
    (void)jj;
  };
  auto add = [](float& s, float v) { s = SQ ? fmaf(v, v, s) : s + v; };
  const int h = min(e, mid0 - 1);
  for (; j <= h; ++j) {  // a head row: the windows of some accumulators
    float v[VEC];
    take(v, j);
    const int d = j - cb;
#pragma unroll
    for (int m = 0; m < kWalkM; ++m)
      if (m >= d - b && m <= d + a)
#pragma unroll
        for (int u = 0; u < VEC; ++u) add(acc[m][u], v[u]);
  }
  const int mm = min(e, mid1);
#pragma unroll 4
  for (; j <= mm; ++j) {  // in every window
    float v[VEC];
    take(v, j);
#pragma unroll
    for (int m = 0; m < kWalkM; ++m)
#pragma unroll
      for (int u = 0; u < VEC; ++u) add(acc[m][u], v[u]);
  }
  for (; j <= e; ++j) {  // a tail row
    float v[VEC];
    take(v, j);
    const int d = j - cb;
#pragma unroll
    for (int m = 0; m < kWalkM; ++m)
      if (m >= d - b && m <= d + a)
#pragma unroll
        for (int u = 0; u < VEC; ++u) add(acc[m][u], v[u]);
  }
}

// acc[m] += the squares (SQ) or values of rows [cb + m - a, cb + m + b] ∩
// [0, C), each in channel order, for a span whose rows are all staged
// (row(j, v): row j at this thread's columns). The window is at least M
// wide (every window past kMaxSize), so the span's first M - 1 rows, row
// h of them taken by accumulators 0..h, and its last M - 1, row h by
// h..M-1, are unrolled with no test of which accumulator takes a row;
// the rows between are in every window
template <bool SQ, int VEC, typename Row>
__device__ __forceinline__ void walk_span(float (&acc)[kWalkM][VEC], int cb,
                                          int a, int b, int C, Row row) {
  constexpr int M = kWalkM;
  auto add = [](float& s, float v) { s = SQ ? fmaf(v, v, s) : s + v; };
#pragma unroll
  for (int h = 0; h < M - 1; ++h) {
    const int j = cb - a + h;
    if (j >= 0 && j < C) {
      float v[VEC];
      row(j, v);
#pragma unroll
      for (int m = 0; m <= h; ++m)
#pragma unroll
        for (int u = 0; u < VEC; ++u) add(acc[m][u], v[u]);
    }
  }
  const int j1 = min(cb + b, C - 1);
#pragma unroll 4
  for (int j = max(cb - a + M - 1, 0); j <= j1; ++j) {
    float v[VEC];
    row(j, v);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int u = 0; u < VEC; ++u) add(acc[m][u], v[u]);
  }
#pragma unroll
  for (int h = 1; h < M; ++h) {
    const int j = cb + b + h;
    if (j >= 0 && j < C) {
      float v[VEC];
      row(j, v);
#pragma unroll
      for (int m = h; m < M; ++m)
#pragma unroll
        for (int u = 0; u < VEC; ++u) add(acc[m][u], v[u]);
    }
  }
}

// the rows [mid0, mid1] every window [cb + m - a, cb + m + b] of
// [j0, j1] holds (mid0 > j1: none)
__device__ __forceinline__ void mid_rows(int cb, int a, int b, int j0,
                                         int j1, int& mid0, int& mid1) {
  mid0 = max(cb + kWalkM - 1 - a, j0);
  mid1 = min(cb + b, j1);
  if (mid0 > mid1) mid0 = mid1 = j1 + 1;
}

// The staged span of a CTA: rows [x0, x1] of `src`'s channel planes at
// its run, in chunks of kWalkChunk rows, chunk k in slot k % S on full
// mbarrier k % S (S below the chunks: a ring, refilled once every
// consumer warp has arrived on the slot's empty mbarrier); nk mbarriers
// complete (a buffer's S, each once a use, where a span has fewer
// chunks). Warp 0's lane
// r copies row r of a chunk: its whole 16-byte chunks by one bulk copy,
// its ends element by element (as the staged backward's warp 0)
template <typename S>
__device__ __forceinline__ void stage_span(const S* __restrict__ src,
                                           int64_t base, int64_t HW, int x0,
                                           int x1, int len, int slots,
                                           int nk, int rb,
                                           unsigned char* stages,
                                           uint32_t full, uint32_t empty,
                                           int lane) {
  const int bytes = len * (int)sizeof(S);
  for (int k = 0; k < nk; ++k) {  // nk past the span's chunks: arrivals
    const int s = k % slots;
    if (k >= slots) hopper::bar_wait(empty + 8 * s, (k / slots - 1) & 1);
    const uint32_t bar = full + 8 * s;
    const int ch = x0 + k * kWalkChunk + lane;
    if (lane < kWalkChunk && ch <= x1) {
      const RowSpan sp(src + base + (int64_t)ch * HW, bytes);
      unsigned char* to = stages + (size_t)(s * kWalkChunk + lane) * rb;
      if (sp.bytes()) {
        expect_tx(bar, sp.bytes());
        hopper::bulk_load(hopper::smem_u32(to + sp.at(sp.lo)),
                          (const void*)sp.lo, sp.bytes(), bar);
      }
      for (uintptr_t u = sp.a; u < sp.lo; u += sizeof(S))
        *reinterpret_cast<S*>(to + sp.at(u)) = *reinterpret_cast<const S*>(u);
      for (uintptr_t u = sp.hi; u < sp.end; u += sizeof(S))
        *reinterpret_cast<S*>(to + sp.at(u)) = *reinterpret_cast<const S*>(u);
    }
    hopper::bar_arrive(bar);  // one of 32
  }
}

// where a CTA of the tiled walk works: image n, a run of len positions
// from p0, channels from c0
struct Place {
  int64_t base;  // (n, p0) in elements
  int len, c0;
};
__device__ __forceinline__ Place place_of(const Tiled& a, int64_t unit) {
  const int tile = (int)(unit % a.tiles);
  const int64_t nr = unit / a.tiles;
  const int64_t n = nr / a.runs;
  const int64_t p0 = (nr - n * a.runs) * a.P;
  const int64_t rest = a.HW - p0;
  return Place{n * a.C * a.HW + p0, (int)(rest < a.P ? rest : a.P),
               tile * a.CT};
}

// The tiled walk (forward, and the two launches of the "any" backward
// past its cap). A CTA: image n, a run of P positions, a tile of CT
// output channels; warp 0 stages the span of `src` rows the tile's
// windows [c - a, c + b] cover; consumer warp w is group w / W (M
// channels from c0 + M*(w / W)) at columns 32*VEC*(w % W) on. KIND:
// kKindFwd y = r * s^-beta (src x, out y); kKindT t = g*r*s^-beta/s and
// u = g*s^-beta to tout's two halves (src x); kKindDx dx from the adjoint
// sums of t (src t, tout's second half u, x for r; out dx)
template <typename T, typename S, int KIND, bool ALIGNED>
__global__ void __launch_bounds__(kWalkThreads, 2)
    lrn_tiled_kernel(const S* __restrict__ src, const T* __restrict__ x,
                     const T* __restrict__ g, T* __restrict__ out,
                     float* __restrict__ tout, int64_t numel, Tiled a) {
  constexpr int M = kWalkM, K = kWalkChunk, VEC = 4 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const bool persist = a.bufs == 2;
  const int NS = a.bufs * a.S;
  const uint32_t full = hopper::smem_u32(smem), empty = full + 8 * NS;
  unsigned char* stages = smem + walk_bar_bytes(NS);
  const int C = a.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::bar_init(full + 8 * s, 32);
      hopper::bar_init(empty + 8 * s, blockDim.x / 32 - 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this CTA's units: blockIdx.x, + gridDim.x, ... (persistent: the it-th
  // in buffer it % 2, its mbarriers' phase (it / 2) % 2)
  auto span_of = [&](const Place& pl, int& x0, int& x1) {
    x0 = max(pl.c0 - a.a, 0);
    x1 = min(pl.c0 + a.CT - 1 + a.b, C - 1);
  };
  if (warp == 0) {
    int it = 0;
    for (int64_t u = blockIdx.x; u < a.units; u += gridDim.x, ++it) {
      const Place pl = place_of(a, u);
      int x0, x1;
      span_of(pl, x0, x1);
      const int b = persist ? it & 1 : 0;
      if (persist && it >= 2)
        hopper::bar_wait(empty + 8 * b * a.S, ((it >> 1) - 1) & 1);
      stage_span<S>(src, pl.base, a.HW, x0, x1, pl.len, a.S,
                    persist ? a.S : (x1 - x0 + K) / K, a.rb,
                    stages + (size_t)b * a.S * K * a.rb, full + 8 * b * a.S,
                    empty, lane);
    }
    return;
  }

  const int grp = (warp - 1) / a.W;
  const int col = (((warp - 1) % a.W) * 32 + lane) * VEC;
  const int dm = (int)((a.HW * (int64_t)sizeof(S)) & 15);
  const int dmo = (int)((a.HW * (int64_t)sizeof(T)) & 15);
  const bool relu_rows = KIND != kKindDx && a.relu;
  int it = 0;
  for (int64_t unit = blockIdx.x; unit < a.units;
       unit += gridDim.x, ++it) {
    const Place pl = place_of(a, unit);
    int x0, x1;
    span_of(pl, x0, x1);
    const int chunks = (x1 - x0 + K) / K;
    const bool ring = !persist && chunks > a.S;
    const int b = persist ? it & 1 : 0;
    unsigned char* st = stages + (size_t)b * a.S * K * a.rb;
    const uint32_t fb = full + 8 * b * a.S;
    const uint32_t parity = persist ? (it >> 1) & 1 : 0;
    const bool active = col < pl.len;
    const int toff = (active ? col : 0) * (int)sizeof(S);
    const int cb = pl.c0 + grp * M;
    const bool idle = cb >= C;
    const int mx = (int)((uintptr_t)(src + pl.base) & 15);
    float acc[M][VEC];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[m][u] = 0.0f;
    if (!idle && !ring) {  // the span staged whole: the group's chunks
      const int j0 = max(cb - a.a, 0), j1 = min(cb + M - 1 + a.b, C - 1);
      for (int kc = (j0 - x0) / K; kc <= (j1 - x0) / K; ++kc)
        hopper::bar_wait(fb + 8 * kc, parity);
      if constexpr (KIND == kKindDx) {  // t rows: no relu
        walk_span<false, VEC>(acc, cb, a.a, a.b, C,
                              [&](int j, float (&v)[VEC]) {
          read_staged<S, VEC, ALIGNED>(st + (size_t)(j - x0) * a.rb + toff,
                                       (mx + j * dm) & 15, v);
        });
      } else {
        const uint32_t floor = sq_floor<S>(a.relu);
        walk_span<true, VEC>(acc, cb, a.a, a.b, C,
                             [&](int j, float (&v)[VEC]) {
          read_sq_row<S, VEC, ALIGNED>(st + (size_t)(j - x0) * a.rb + toff,
                                       (mx + j * dm) & 15, floor, v);
        });
      }
    } else if (ring) {  // each chunk walked, then freed, in channel order
      int j0 = max(cb - a.a, 0), j1 = min(cb + M - 1 + a.b, C - 1);
      if (idle) j0 = x1 + 1, j1 = x1;
      int mid0, mid1;
      mid_rows(cb, a.a, a.b, j0, j1, mid0, mid1);
      for (int kc = 0; kc < chunks; ++kc) {
        const int s = kc % a.S;
        hopper::bar_wait(full + 8 * s, (kc / a.S) & 1);
        const int r0 = x0 + kc * K, f = max(j0, r0), e = min(j1, r0 + K - 1);
        if (f <= e) {
          const unsigned char* p =
              stages + (size_t)(s * K + f - r0) * a.rb + toff;
          const int m0 = mx + f * dm;
          if (relu_rows)
            walk_rows<KIND != kKindDx, true, S, VEC, ALIGNED>(
                acc, p, a.rb, m0, dm, f, e, cb, a.a, a.b, mid0, mid1);
          else
            walk_rows<KIND != kKindDx, false, S, VEC, ALIGNED>(
                acc, p, a.rb, m0, dm, f, e, cb, a.a, a.b, mid0, mid1);
        }
        __syncwarp();
        if (lane == 0) hopper::bar_arrive(empty + 8 * s);
      }
    }
    if (!idle && active) {
    const int md = (int)((uintptr_t)(out + pl.base) & 15);
    // output channel cb + m, at beta's mode MODE (-1: chosen at run time).
    // r: the staged row, or where the span went round a ring (and for
    // kKindDx, whose rows are t) x from device memory, as g and u
    auto channel = [&](int m, auto mode) {
      constexpr int MODE = decltype(mode)::value;
      const int c = cb + m;
      const int64_t at = pl.base + (int64_t)c * a.HW;
      float r[VEC], o[VEC];
      if (KIND == kKindDx || ring)
        load_cols<T, VEC, ALIGNED>(x + at, col, pl.len, r);
      else
        read_staged<S, VEC, ALIGNED>(st + (size_t)(c - x0) * a.rb + toff,
                                     (mx + c * dm) & 15, r);
      relu_if(r, a.relu);
      if constexpr (KIND == kKindFwd) {
        // the same expressions as the plain order's: k + coef * sum (an
        // fma), r * s^-beta
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          o[u] = r[u] * pow_neg_beta_at<MODE>(fmaf(a.coef, acc[m][u], a.k),
                                              a.mode, a.beta);
        write_row<T, VEC, ALIGNED>(out + at, md + c * dmo, col, pl.len, o);
      } else if constexpr (KIND == kKindT) {
        float gv[VEC], t[VEC];
        load_cols<T, VEC, ALIGNED>(g + at, col, pl.len, gv);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          float b, bs;
          pow_pair_at<MODE>(fmaf(a.coef, acc[m][u], a.k), a.mode, a.beta, b,
                            bs);
          t[u] = gv[u] * r[u] * bs;
          o[u] = gv[u] * b;
        }
        store_cols<VEC>(tout + at, col, pl.len, t);
        store_cols<VEC>(tout + numel + at, col, pl.len, o);
      } else {
        float uv[VEC];
        load_cols<float, VEC, false>(tout + numel + at, col, pl.len, uv);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          // dx = u - coef2*r*sum, one rounding of the product's sum
          const float d = fmaf(-a.coef2 * r[u], acc[m][u], uv[u]);
          o[u] = (a.relu && !(r[u] > 0.0f)) ? 0.0f : d;
        }
        write_row<T, VEC, ALIGNED>(out + at, md + c * dmo, col, pl.len, o);
      }
    };
    // a whole group: no early exit and beta's mode fixed, so the channels'
    // chains interleave
    auto whole = [&](auto mode) {
#pragma unroll
      for (int m = 0; m < M; ++m) channel(m, mode);
    };
    if (cb + M <= C) {
      switch (a.mode) {
        case 0: whole(Mode<0>{}); break;
        case 1: whole(Mode<1>{}); break;
        case 2: whole(Mode<2>{}); break;
        default: whole(Mode<3>{}); break;
      }
    } else {
#pragma unroll
      for (int m = 0; m < M; ++m)
        if (cb + m < C) channel(m, Mode<-1>{});
    }
    }  // the epilogue
    if (persist) {  // this buffer's span walked: free it (a group past
      // C first waits for the span, or it would free the buffer's next
      // use before that was staged)
      if (idle) hopper::bar_wait(fb, parity);
      __syncwarp();
      if (lane == 0) hopper::bar_arrive(empty + 8 * b * a.S);
    }
  }  // the units
}

// The one-launch "any" backward. A CTA: image n, a run of P = 32*VEC
// positions, a tile of CT output channels (all of C where it fits). Warp
// 0 stages the x rows of the tile's adjoint windows' windows, all at
// once; consumer warp w walks, in phase A, t-groups q = qmin + w - 1,
// + G, ... (M channels from c0 + M*q each, covering [c0 - hi, c0 + CT -
// 1 + lo]): s over the staged rows, t = g*r*s^-beta/s into the t rows and,
// for the tile's own channels, u = g*s^-beta into the u rows (shared
// memory, f32); in phase B, after a barrier of the consumers, output
// groups q = w - 1, + G, ...: the adjoint sums over the t rows, dx = u -
// coef2*r*sum, stored from registers
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kWalkThreads)
    lrn_bwd_tiled_kernel(const T* __restrict__ g, const T* __restrict__ x,
                         T* __restrict__ dx, Tiled a) {
  constexpr int M = kWalkM, K = kWalkChunk, VEC = 4 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const Place pl = place_of(a, blockIdx.x);
  const int C = a.C, c0 = pl.c0, lo = a.lo, hi = a.hi;
  const int qmin = -min((hi + M - 1) / M, c0 / M);
  const int qmax = (min(c0 + a.CT - 1 + lo, C - 1) - c0) / M;
  const int tbase = c0 + qmin * M;
  const int x0 = max(tbase - lo, 0);
  const int x1 = min(c0 + qmax * M + M - 1 + hi, C - 1);
  const int chunks = (x1 - x0 + K) / K;
  const uint32_t full = hopper::smem_u32(smem);
  unsigned char* stages = smem + walk_bar_bytes(a.S);
  float* tr = reinterpret_cast<float*>(stages + (size_t)a.S * K * a.rb);
  float* ur = tr + (size_t)(qmax - qmin + 1) * M * a.P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < chunks; ++s) hopper::bar_init(full + 8 * s, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    stage_span<T>(x, pl.base, a.HW, x0, x1, pl.len, chunks, chunks, a.rb,
                  stages, full, full + 8 * a.S, lane);
    return;
  }

  const int G = blockDim.x / 32 - 1, w = warp - 1;
  const int col = lane * VEC;
  const bool active = col < pl.len;
  const int toff = (active ? col : 0) * (int)sizeof(T);
  const int mx = (int)((uintptr_t)(x + pl.base) & 15);
  const int dm = (int)((a.HW * (int64_t)sizeof(T)) & 15);

  const uint32_t floor = sq_floor<T>(a.relu);
  auto xrow = [&](int j, float (&v)[VEC]) {
    read_staged<T, VEC, ALIGNED>(stages + (size_t)(j - x0) * a.rb + toff,
                                 (mx + j * dm) & 15, v);
    relu_if(v, a.relu);
  };
  // phase A: t of channels [tbase, c0 + M*qmax + M), u of [c0, c0 + CT)
  for (int q = qmin + w; q <= qmax; q += G) {
    const int jb = c0 + q * M;
    float gv[M][VEC], acc[M][VEC];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      load_cols<T, VEC, ALIGNED>(
          g + pl.base + (int64_t)min(jb + m, C - 1) * a.HW, col, pl.len,
          gv[m]);
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[m][u] = 0.0f;
    }
    const int j0 = max(jb - lo, 0), j1 = min(jb + M - 1 + hi, C - 1);
    for (int kc = (j0 - x0) / K; kc <= (j1 - x0) / K; ++kc)
      hopper::bar_wait(full + 8 * kc, 0);
    walk_span<true, VEC>(acc, jb, lo, hi, C, [&](int j, float (&v)[VEC]) {
      read_sq_row<T, VEC, ALIGNED>(stages + (size_t)(j - x0) * a.rb + toff,
                                   (mx + j * dm) & 15, floor, v);
    });
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = jb + m;
      if (j >= C) break;
      float r[VEC], t[VEC], u[VEC];
      xrow(j, r);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float b, bs;
        pow_pair_rt(a.mode, fmaf(a.coef, acc[m][e], a.k), a.beta, b, bs);
        t[e] = gv[m][e] * r[e] * bs;
        u[e] = gv[m][e] * b;
      }
      st_slot<VEC>(tr + (size_t)(j - tbase) * a.P + col, t);
      if (j - c0 >= 0 && j - c0 < a.CT)
        st_slot<VEC>(ur + (size_t)(j - c0) * a.P + col, u);
    }
  }
  hopper::named_sync(1, G * 32);

  // phase B: dx of the tile's channels from the adjoint sums of t
  const int md = (int)((uintptr_t)(dx + pl.base) & 15);
  for (int q = w; q * M < a.CT && c0 + q * M < C; q += G) {
    const int cb = c0 + q * M;
    float acc[M][VEC];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[m][u] = 0.0f;
    walk_span<false, VEC>(acc, cb, hi, lo, C, [&](int j, float (&v)[VEC]) {
      ld_slot<VEC>(tr + (size_t)(j - tbase) * a.P + col, v);
    });
    if (!active) continue;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = cb + m;
      if (c >= C) break;
      float r[VEC], u[VEC], o[VEC];
      xrow(c, r);
      ld_slot<VEC>(ur + (size_t)(c - c0) * a.P + col, u);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = fmaf(-a.coef2 * r[e], acc[m][e], u[e]);
        o[e] = (a.relu && !(r[e] > 0.0f)) ? 0.0f : d;
      }
      write_row<T, VEC, ALIGNED>(dx + pl.base + (int64_t)c * a.HW,
                                 md + c * dm, col, pl.len, o);
    }
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
  float* scratch;  // the "any" backward's two-launch form: t, then u
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

template <typename T, int SIZE>
int launch_vec(const void* x, void* out, const Args& a) {
  const bool vec4 = a.HW % 4 == 0 && aligned<T>(x, 4) && aligned<T>(out, 4);
  return vec4 ? launch<T, SIZE, 4>(x, out, a) : launch<T, SIZE, 1>(x, out, a);
}

// the tiled walk's launch: runs of P = 32*VEC*W positions (W halved
// while the grid is under kWalkMinCtas), tiles of CT = kWalkTile channels
// (fewer where C is), a span of min(C, CT + size - 1) rows of selt-byte
// elements staged whole, into two buffers (bufs 2: persistent CTAs)
// where both fit kWalkCtaBytes, else one, or past it through a ring of S
// chunks. bwd_plan's W: its consumer warps
struct Plan {
  int W, P, CT, tiles, rb, S, bufs;
  int64_t runs, smem;
};
Plan walk_plan(int N, int C, int64_t HW, int size, int telt, int selt) {
  Plan p;
  p.CT = (C + kWalkM - 1) / kWalkM * kWalkM;
  if (p.CT > kWalkTile) p.CT = kWalkTile;
  p.tiles = (C + p.CT - 1) / p.CT;
  p.W = kWalkWarps;
  while (p.W > 1 && (int64_t)N * ((HW + 32 * (4 / telt) * p.W - 1)
                                  / (32 * (4 / telt) * p.W)) * p.tiles
                        < kWalkMinCtas)
    p.W /= 2;
  p.P = 32 * (4 / telt) * p.W;
  p.runs = (HW + p.P - 1) / p.P;
  p.rb = row_bytes(p.P, selt);
  const int rows = C < p.CT + size - 1 ? C : p.CT + size - 1;
  p.S = (rows + kWalkChunk - 1) / kWalkChunk;
  p.bufs = walk_bar_bytes(2 * p.S) + (int64_t)2 * p.S * kWalkChunk * p.rb
                   <= kWalkCtaBytes ? 2 : 1;
  while (p.S > 2 && walk_bar_bytes(p.bufs * p.S)
                        + (int64_t)p.bufs * p.S * kWalkChunk * p.rb
                        > kWalkCtaBytes)
    --p.S;
  p.smem = walk_bar_bytes(p.bufs * p.S)
           + (int64_t)p.bufs * p.S * kWalkChunk * p.rb;
  return p;
}

// the one-launch "any" backward's: runs of P = 32*VEC positions, the
// widest tile CT (a multiple of M, all of C where it fits) whose x span,
// t rows and u rows fit a block's shared memory; CT 0: none fits, the
// two-launch form
Plan bwd_plan(int C, int64_t HW, int size, int elt) {
  constexpr int M = kWalkM, K = kWalkChunk;
  const int lo = (size - 1) / 2, hi = size - 1 - lo;
  Plan p{1, 32 * (4 / elt), 0, 0, row_bytes(32 * (4 / elt), elt), 0, 1, 0,
         0};
  const int groups = (C + M - 1) / M;
  for (int ct = groups * M; ct >= M; ct -= M) {
    const int span = (hi + M - 1) / M + (ct - 1 + lo) / M + 1;
    const int trows = M * (span < groups ? span : groups);
    const int xrows = C < trows + size - 1 ? C : trows + size - 1;
    const int S = (xrows + K - 1) / K;
    const int64_t smem = walk_bar_bytes(S) + (int64_t)S * K * p.rb
                         + (int64_t)(trows + ct) * p.P * 4;
    if (smem <= kSmemMax) {
      p.CT = ct;
      p.S = S;
      p.W = trows / M < kWalkGroups ? trows / M : kWalkGroups;  // warps
      p.smem = smem;
      break;
    }
  }
  p.tiles = p.CT ? (C + p.CT - 1) / p.CT : 0;
  p.runs = (HW + p.P - 1) / p.P;
  return p;
}

Tiled tiled_args(const Plan& p, const Args& a, bool adjoint) {
  const int lo = (a.size - 1) / 2, hi = a.size - 1 - lo;
  return Tiled{a.C, a.HW, p.P, p.W, (int)p.runs, p.tiles, p.CT, p.rb,
               adjoint ? hi : lo, adjoint ? lo : hi, p.S, p.bufs,
               (int64_t)a.N * p.runs * p.tiles, lo, hi,
               a.alpha / a.size, a.k, a.beta,
               2.0f * a.alpha * a.beta / a.size, beta_mode(a.beta), a.relu};
}

// a pass of the tiled walk over rows of src (S: T, or the f32 scratch)
template <typename T, typename S, int KIND, bool ALIGNED>
int launch_tiled(const S* src, const T* x, const T* g, T* out, float* tout,
                 const Args& a) {
  const Plan p = walk_plan(a.N, a.C, a.HW, a.size, sizeof(T), sizeof(S));
  const int64_t units = (int64_t)a.N * p.runs * p.tiles;
  const int threads = 32 * (1 + p.CT / kWalkM * p.W);
  auto kernel = lrn_tiled_kernel<T, S, KIND, ALIGNED>;
  int err = hopper::set_smem(kernel, (size_t)p.smem);
  if (err) return err;
  int64_t blocks = units;
  if (p.bufs == 2) {  // persistent: as many CTAs as fit the card at once
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = (int)cudaGetDevice(&dev))
        || (err = (int)cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, dev))
        || (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, (size_t)p.smem)))
      return err;
    if (per_sm < 1) return -4;
    if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  }
  if (blocks > 0x7fffffff) return -4;
  kernel<<<(unsigned)blocks, threads, (size_t)p.smem, a.st>>>(
      src, x, g, out, tout, (int64_t)a.N * a.C * a.HW,
      tiled_args(p, a, KIND == kKindDx));
  return (int)cudaGetLastError();
}

// rows of whole 16-byte chunks from 16-byte aligned pointers
template <typename T>
bool whole_rows(const Args& a, const void* p, const void* q, const void* r) {
  return a.HW * sizeof(T) % 16 == 0 && aligned<T>(p, 16 / sizeof(T))
         && aligned<T>(q, 16 / sizeof(T))
         && (r == nullptr || aligned<T>(r, 16 / sizeof(T)));
}

template <typename T>
int launch_fwd(const void* x, void* y, const Args& a) {
  switch (a.size) {
    case 1: return launch_vec<T, 1>(x, y, a);
    case 2: return launch_vec<T, 2>(x, y, a);
    case 3: return launch_vec<T, 3>(x, y, a);
    case 4: return launch_vec<T, 4>(x, y, a);
    case 5: return launch_vec<T, 5>(x, y, a);
    case 6: return launch_vec<T, 6>(x, y, a);
    case 7: return launch_vec<T, 7>(x, y, a);
    case 8: return launch_vec<T, 8>(x, y, a);
    case 9: return launch_vec<T, kMaxSize>(x, y, a);
    default: break;
  }
  if (a.size < 1) return -3;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  return whole_rows<T>(a, x, y, nullptr)
             ? launch_tiled<T, T, kKindFwd, true>(xs, xs, nullptr, ys,
                                                  nullptr, a)
             : launch_tiled<T, T, kKindFwd, false>(xs, xs, nullptr, ys,
                                                   nullptr, a);
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

// the "any" backward: one launch of lrn_bwd_tiled_kernel where a tile
// fits (bwd_plan), else the two-launch form through the scratch
template <typename T>
int launch_any(const void* g, const void* x, void* dx, const Args& a) {
  const Plan p = bwd_plan(a.C, a.HW, a.size, sizeof(T));
  const T* gs = static_cast<const T*>(g);
  const T* xs = static_cast<const T*>(x);
  T* dxs = static_cast<T*>(dx);
  if (p.CT == 0) {
    if (a.scratch == nullptr) return -5;
    int err = launch_tiled<T, T, kKindT, false>(xs, xs, gs, nullptr,
                                                a.scratch, a);
    if (err) return err;
    return launch_tiled<T, float, kKindDx, false>(a.scratch, xs, nullptr,
                                                  dxs, a.scratch, a);
  }
  const int64_t blocks = (int64_t)a.N * p.runs * p.tiles;
  if (blocks > 0x7fffffff) return -4;
  auto kernel = whole_rows<T>(a, g, x, dx) ? lrn_bwd_tiled_kernel<T, true>
                                           : lrn_bwd_tiled_kernel<T, false>;
  const int err = hopper::set_smem(kernel, (size_t)p.smem);
  if (err) return err;
  kernel<<<(unsigned)blocks, 32 * (1 + p.W), (size_t)p.smem, a.st>>>(
      gs, xs, dxs, tiled_args(p, a, false));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(int route, const void* g, const void* x, void* dx,
               const Args& a) {
  if (route == kRouteAny) return launch_any<T>(g, x, dx, a);
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
// any size >= 1. scratch: where the "any" route takes its two-launch form
// (no tile fits shared memory: bwd_plan), an f32 scratch of 2*N*C*H*W
// elements (t, then u), 16-byte aligned (unused, and may be null,
// elsewhere). *route (when not null): the route taken, 0 "staged", 1
// "any" (route_of). Returns 0, or a CUDA error code (negative:
// unsupported dtype / size / grid, or -5 for the two-launch form without
// its scratch).
extern "C" int bigdl_lrn_bwd(int dtype, const void* g, const void* x,
                             void* dx, float* scratch, int N, int C, int HW,
                             int size, float alpha, float beta, float k,
                             int relu, void* stream, int* route) {
  Args a{N, C, HW, alpha, beta, k, size, relu, scratch,
         static_cast<cudaStream_t>(stream)};
  if (dtype != 0 && dtype != 1) return -2;
  if (size < 1) return -3;
  const int r = route_of(C, size);
  if (route != nullptr) *route = r;
  return dtype == 0 ? launch_bwd<float>(r, g, x, dx, a)
                    : launch_bwd<__nv_bfloat16>(r, g, x, dx, a);
}

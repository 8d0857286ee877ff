// 3xTF32 on Hopper's tensor cores (sm_90a): the building blocks shared by
// the f32 kernels of flash_attention.cu (the forward, dq and dk/dv at
// every head dim) and of fused_ce.cu (the forward, dh and dW/db), which
// their headers describe. A float x splits into hi = tf32(x) and lo = tf32(x - hi);
// hi·lo + lo·hi + hi·hi on wgmma m64n64k8.f32.tf32.tf32 keeps about 22 of
// f32's 24 bits, and every few K steps sum in a fresh accumulator added
// in f32, because the tensor cores truncate what they add to a running
// sum. Here: the tile layout TMA lands ([64 rows][32 f32] boxes in the
// 128-byte swizzle), a score step (A split in registers, B's parts from
// shared memory), an output step (A from a raw box, B a tile of parts),
// the parts of an accumulator into shared memory and back, the hand-over
// of an accumulator between two warpgroups, the ring of stages of a
// kernel with a producer warpgroup and two consumer warpgroups, and the
// split pass that writes a walked operand's parts before such a kernel.

#pragma once

#include "hopper.cuh"       // mbarriers, TMA, wgmma, tf32 rounding

namespace {
namespace hopper {

constexpr int kTfRows = 64;                   // rows of a box and a tile
constexpr int kTfBox = kTfRows * kRowBytes;   // [64][32] f32: 8 KB
// K steps of 8 a score step sums afresh (of its 4)
constexpr int kTfScoreKs = 2;
// a stage of the ring: A0, B0 hi, A1, B1 hi, B0 lo, B1 lo: 48 KB
constexpr int kTfStage = 6 * kTfBox;
// 64-column chunks a consumer warpgroup accumulates: 128 registers of
// accumulator beside a score tile, its per-step sum and A's parts (96),
// or beside an output step's sum and A's parts
constexpr int kTfMaxOwn = 4;
constexpr int kTfConsumers = 256;            // two consumer warpgroups
constexpr int kTfThreads = kTfConsumers + 128;   // + the producer warpgroup
// stages a ring may have (its barriers full[kTfMaxStages],
// empty[kTfMaxStages] come first in the kernel's barrier block)
constexpr int kTfMaxStages = 16;
// registers a producer thread and a consumer thread hold: setmaxnreg
// moves registers only within the CTA, out of the 168 a thread (65536 /
// 384, a multiple of 8) it holds at launch
constexpr int kTfProducerRegs = 24, kTfConsumerRegs = 240;
static_assert(128 * kTfProducerRegs + kTfConsumers * kTfConsumerRegs <=
                  kTfThreads * 168,
              "setmaxnreg counts must fit the registers held at launch");

// byte offset of f32 element (r, c) of a [rows][32] tile in TMA's 128-byte
// swizzle: 16-byte chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ uint32_t tf_at(int r, int c) {
  return r * kRowBytes + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// One score step: s (+)= A·Bᵀ over 32 columns, A (a_t, the raw f32 box of
// this CTA's 64 rows: warp w of the warpgroup rows 16w..16w + 15) split
// into tf32 high and low parts in registers, B (the walked tile's rows)
// as its high part at b_t and its low part at blo.
// The step's products sum in a fresh accumulator, the low terms first
// (hi·lo, lo·hi: four K steps of 8 each), then hi·hi, 12 wgmma m64n64k8;
// s gains the sum in f32 (first: s = the sum). The tensor cores add each
// product to the accumulator truncated to its precision, so a chain over
// all of D (or low terms added after the high ones) loses a bit of the
// running sum's magnitude at every step; summing each step apart keeps
// that loss to the step's own terms. Returns once the products are done,
// so the caller may release the stage.
__device__ __forceinline__ void tf_score_step(float (&s)[32], uint32_t a_t,
                                              uint32_t b_t, uint32_t blo,
                                              bool first) {
  const int i = threadIdx.x % 128, l = i % 32;
  const int r0 = 16 * (i / 32) + l / 4, t = l % 4;
#pragma unroll
  for (int k0 = 0; k0 < 4; k0 += kTfScoreKs) {
    uint32_t ah[kTfScoreKs][4], al[kTfScoreKs][4];
#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(ld_shared(a_t + tf_at(r0 + 8 * (e & 1),
                                          8 * (k0 + kk) + t + 4 * (e >> 1))),
                   ah[kk][e], al[kk][e]);
    float acc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk) {
      const uint32_t k = 32 * (k0 + kk);
      wgmma_tf32_rs_n64(acc, ah[kk], desc(blo + k), kk > 0);
      wgmma_tf32_rs_n64(acc, al[kk], desc(b_t + k), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kTfScoreKs; ++kk)
      wgmma_tf32_rs_n64(acc, ah[kk], desc(b_t + 32 * (k0 + kk)), 1);
    wg_commit();
    wg_wait();
    keep(acc);
    keep(ah);
    keep(al);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = first && k0 == 0 ? acc[e] : s[e] + acc[e];
  }
}

// s (a 64 x 64 accumulator: rows this CTA's, columns the walked tile's) as
// tf32 high and low parts into hi and lo, each two [64][32] tiles (columns
// 0-31, 32-63) in the 128-byte swizzle: the K-major B operand of the
// output steps. (The caller fences and syncs before wgmma reads them.)
__device__ __forceinline__ void tf_put(uint32_t hi, uint32_t lo,
                                       const float (&s)[32]) {
  const int i = threadIdx.x % 128, l = i % 32;
#pragma unroll
  for (int j = 0; j < 16; ++j) {           // element pairs 2j, 2j + 1
    const int r = 16 * (i / 32) + l / 4 + 8 * (j % 2);
    const int c = 8 * (j / 2) + 2 * (l % 4);
    const uint32_t off = (c / 32) * kTfBox + tf_at(r, c % 32);
    uint32_t h0, l0, h1, l1;
    split_tf32(s[2 * j], h0, l0);
    split_tf32(s[2 * j + 1], h1, l1);
    st_shared2(hi + off, __uint_as_float(h0), __uint_as_float(h1));
    st_shared2(lo + off, __uint_as_float(l0), __uint_as_float(l1));
  }
}
// the f32 values (hi + lo) tf_put wrote, at this thread's positions
__device__ __forceinline__ void tf_get(float (&s)[32], uint32_t hi,
                                       uint32_t lo) {
  const int i = threadIdx.x % 128, l = i % 32;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = 16 * (i / 32) + l / 4 + 8 * (j % 2);
    const int c = 8 * (j / 2) + 2 * (l % 4);
    const uint32_t off = (c / 32) * kTfBox + tf_at(r, c % 32);
    float h[2], w[2];
    ld_shared2(hi + off, h);
    ld_shared2(lo + off, w);
    s[2 * j] = h[0] + w[0];
    s[2 * j + 1] = h[1] + w[1];
  }
}

// One output step: acc (a 64 x 64 block of the output's transpose: rows
// 64 of its columns, columns this CTA's rows) += A·B over the walked
// tile's 64 rows, A those columns of the walked tile (the raw f32 tiles
// at `tile`, [64 rows][32 columns] twice) split into tf32 parts in
// registers, B the parts of P or dS (tf_put's tiles bhi, blo), K-major.
// Per K step of 8 rows hi·lo, lo·hi, hi·hi, 24 wgmma m64n64k8 into a
// fresh accumulator added to acc in f32 (tf_score_step's reason). Where
// the chunk holds `cols` 32 columns (head dim 32: its second raw tile was
// not loaded), warps 2 and 3 take zeros for A, and their rows of acc stay
// zero.
__device__ __forceinline__ void tf_out_step(float (&acc)[32], uint32_t tile,
                                            uint32_t bhi, uint32_t blo,
                                            int cols = 64) {
  const int i = threadIdx.x % 128, l = i % 32, t = l % 4;
  // warp w's rows of A are the block's columns 16w..16w + 15, in tile
  // (16w) / 32
  const int c = (16 * (i / 32)) % 32 + l / 4;
  const uint32_t a_t = tile + (i / 64) * kTfBox;
  const bool live = 16 * (i / 32) < cols;     // uniform in the warp
  // two groups of 4 K steps, so A's parts of only one are held (all 8
  // beside a 4-chunk accumulator spilled), each summed afresh
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float d[32];
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = ld_shared(a_t + tf_at(32 * half + 8 * kk + t +
                                                  4 * (e >> 1),
                                              c + 8 * (e & 1)));
        split_tf32(live ? x : 0.f, ah[kk][e], al[kk][e]);
      }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t k = half * kTfBox + kk * 32;
      wgmma_tf32_rs_n64(d, ah[kk], desc(blo + k), kk > 0);
      wgmma_tf32_rs_n64(d, al[kk], desc(bhi + k), 1);
      wgmma_tf32_rs_n64(d, ah[kk], desc(bhi + k), 1);
    }
    wg_commit();
    wg_wait();
    keep(d);
    keep(ah);
    keep(al);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += d[e];
  }
}

// the ring walked with counters: the step's stage and its phase
struct TfRing {
  uint32_t ring0, bars;
  int ns, st = 0, ph = 0;
  __device__ uint32_t full() const { return bars + 8 * st; }
  __device__ uint32_t empty() const { return bars + 8 * (kTfMaxStages + st); }
  __device__ uint32_t stage() const { return ring0 + st * kTfStage; }
  __device__ void next() {
    if (++st == ns) {
      st = 0;
      ph ^= 1;
    }
  }
  // the producer: wait until step t's stage is free, expect its bytes
  __device__ uint32_t acquire(int t, uint32_t bytes) const {
    if (t >= ns) bar_wait(empty(), ph ^ 1);
    bar_expect(full(), bytes);
    return stage();
  }
  // a consumer warp: wait for the step's stage; release it after
  __device__ uint32_t wait() const {
    warp_wait(full(), ph);
    return stage();
  }
  __device__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) bar_arrive(empty());
    next();
  }
};

__device__ __forceinline__ void tf_init(uint32_t bars, int ns) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(bars + 8 * s, 1);
      bar_init(bars + 8 * (kTfMaxStages + s), kTfConsumers / 32);
    }
    bar_init(bars + 16 * kTfMaxStages, 1);                    // sfull
    bar_init(bars + 16 * kTfMaxStages + 8, kTfConsumers / 32);  // sempty
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A 64 x 64 accumulator (32 f32 a thread) through shared memory between
// the two consumer warpgroups: element e of thread i of a warpgroup at xs
// + 16·(128·(e / 4) + i) + 4·(e % 4), so consecutive threads store and
// load consecutive 16 bytes. tf_give stores s; tf_take adds what the
// thread of the same index in the other warpgroup stored to s.
__device__ __forceinline__ void tf_give(uint32_t xs, const float (&s)[32]) {
  const int i = threadIdx.x % 128;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    st_shared4(xs + 16 * (128 * q + i), s[4 * q], s[4 * q + 1],
               s[4 * q + 2], s[4 * q + 3]);
}
__device__ __forceinline__ void tf_take(float (&s)[32], uint32_t xs) {
  const int i = threadIdx.x % 128;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float x[4];
    ld_shared4(xs + 16 * (128 * q + i), x);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * q + e] += x[e];
  }
}

// x (n4 groups of 4 f32) into its tf32 high and low parts (split_tf32):
// the pass before a 3xTF32 kernel, over the operands it walks
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                  float4* __restrict__ lo, int64_t n4) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    uint32_t h[4], w[4];
    split_tf32(v.x, h[0], w[0]);
    split_tf32(v.y, h[1], w[1]);
    split_tf32(v.z, h[2], w[2]);
    split_tf32(v.w, h[3], w[3]);
    hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo[i] = make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                        __uint_as_float(w[2]), __uint_as_float(w[3]));
  }
}

// the parts of n f32 at x (n a multiple of 4) into hi and lo: a grid of at
// most 8 CTAs an SM of the card's `sms`
inline int tf_split_pass(const void* x, float* hi, float* lo, int64_t n,
                         int sms, cudaStream_t st) {
  const int64_t want = (n / 4 + 255) / 256;
  const int blocks = static_cast<int>(want < 8 * sms ? want : 8 * sms);
  tf32_split_kernel<<<blocks, 256, 0, st>>>(
      static_cast<const float4*>(x), reinterpret_cast<float4*>(hi),
      reinterpret_cast<float4*>(lo), n / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
}  // namespace

// Backward of the 3x3 / stride-1 / SAME max pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` launched by `_bwd_call` in
// bigdl_tpu/ops/pallas/maxpool.py (the pl.pallas_call at line 186). It
// computes the same function, with the forward's y as the residual:
//
//   dx[p] = sum over the windows o that cover p of dy[o] * [p is the
//           first position of window o, in row-major order, with
//           x == y[o]]
//
// (the first-max tie rule of Torch and of XLA's select-and-scatter).
// Out-of-image x is float32's lowest finite value (kFill), as in the TPU
// kernel (maxpool.py:90), not -inf: a window whose in-image maximum is
// -inf then sends its cotangent to its first in-image position, as the
// TPU kernel and the library do. Out-of-image dy is 0 (no window).
//
// Bound on the H100: bytes. x, y and dy are read and dx written, each
// once: 4 x N*C*H*W elements at 3.35 TB/s (0.1227 ms for inception_3b's
// (256, 256, 28, 28) in bf16). The arithmetic is about one compare a
// byte, provided each window's first maximum is found once.
//
// Design, for that bound:
// - Each window's first maximum is found once. Stage 1 writes, for every
//   window o, the offset 0..8 of its first position in row-major order
//   where x == y[o] (9 where nothing matches, as for NaN) as a byte in
//   shared memory; out-of-image positions hold kFill and are compared,
//   not skipped. Stage 2: each output adds dy[o] over the windows whose
//   offset points at it: 9 compares a window and 9 byte tests a position.
//   The sum runs over the nine offsets (dr, dc) in row-major order, in
//   f32 from 0.0, rounded once: the plain version's order (ops/maxpool.py,
//   maxpool3x3s1_bwd_ref), so the two agree bit for bit.
// - Each stage is cut into units of kSeg columns by up to ch rows, about
//   one a thread (Units). A thread walks its unit's rows in order and
//   slides a window of three rows through registers, in slots that
//   rotate, so a step loads one row and moves none: each staged row of
//   its columns is loaded once, not three times. bf16 compares two
//   windows at once (bf16x2, which equals the f32 compare of the casts).
// - Whole planes, read once. NCHW planes are contiguous, so a tile of R
//   consecutive planes is one span of each tensor: thread 0 bulk-copies
//   its whole 16-byte chunks (cp.async.bulk, completing on an mbarrier),
//   warp 1 the few elements at its ends that share a chunk with the
//   neighbouring spans. No halos and no re-reads: SAME padding comes from
//   the planes' own edges. x, y and dy stay in their own dtype in shared
//   memory; y is an input (the forward's residual), never recomputed from
//   x, which would change what NaN inputs give. R, within
//   kPlaneStageBytes for x, y and dy, is the run whose units keep the
//   most of the kThreads threads busy (28 x 28 bf16: 6 planes, 126 units
//   of 10 rows; 14 x 14: 16 planes; 7 x 7: 64).
// - Bytes in flight: persistent CTAs (as many as fit on the card) walk
//   the tiles with a two-stage ring, so the next tile's spans load while
//   this one is computed. dx is staged in the tile's x buffer (x is dead
//   after stage 1) and bulk-stored from there.
// - Planes past the cap take bands of whole rows: a tile of one plane's
//   rows [r0, r0 + BH), still one contiguous span of each tensor, with a
//   2-row halo above and below (clipped at the image edge). Stage 1 finds
//   the offsets of the windows one row past the band too, which the
//   neighbouring band finds again. BH fills kBandStageBytes. Rows too
//   long for kMinBandRows rows in that (W past 682 f32 / 1365 bf16) take
//   blocks of kBlockRows rows by BW columns with a 2-column halo, staged
//   element by element: every (N, C, H, W) that fits the grid is taken.
// - The CPU model of both stages is `_two_stage` in
//   tests/test_torch_maxpool.py; `scripts/maxpool_ab.py --only knockout`
//   times this file with parts removed or settings changed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;     // thread 0 starts the bulk copies, warp 1
static_assert(kThreads >= 64, "");  // the spans' ends
constexpr int kSeg = 4;          // windows / outputs a thread takes in a row
constexpr int64_t kPlaneStageBytes = 32 * 1024;  // whole-plane cap, x+y+dy
constexpr int64_t kBandStageBytes = 48 * 1024;   // band / block stage
constexpr int kMinBandRows = 4;
constexpr int kBlockRows = 16;
constexpr float kFill = -FLT_MAX;  // out-of-image x
constexpr int kNoWindow = 15;      // an offset no position can hold
constexpr int kGuardBytes = 16;

template <typename A>
__host__ __device__ __forceinline__ A least(A a, A b) {
  return a < b ? a : b;
}
template <typename A>
__host__ __device__ __forceinline__ A most(A a, A b) {
  return a < b ? b : a;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// what out-of-image x holds: float32's lowest value; for bf16 NaN, which,
// as that value in the f32 compare, matches no bf16 value
template <typename T> __device__ __forceinline__ T fill_value();
template <> __device__ __forceinline__ float fill_value<float>() {
  return kFill;
}
template <>
__device__ __forceinline__ __nv_bfloat16 fill_value<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0x7fc0);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the tiling, the same for every CTA
struct Geo {
  int64_t planes;
  int H, W;
  int R, BH, BW;            // a tile's output: R planes x BH rows x BW cols
  int64_t tiles_p;
  int tiles_h, tiles_w;
  int buf_elems;            // one tensor's stage buffer, 16 bytes of slack
  int offs_bytes;           // the bordered window offsets
  int fill_elems;           // the fill row
  int contiguous;           // BW == W: a tile's staged rows are one span
  int whole;                // BH == H, BW == W: tiles of whole planes
};

struct Tile {
  int64_t plane0;
  int np;
  int r0, nr, c0, nc;       // outputs
  int sr0, sr1, sc0, sc1;   // staged x, y, dy: outputs +- 2, clipped
  int wr0, wr1, wc0, wc1;   // windows: outputs +- 1, clipped
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int64_t t) {
  Tile s;
  const int per_p = g.tiles_h * g.tiles_w;
  const int64_t tp = per_p == 1 ? t : t / per_p;
  const int rem = (int)(t - tp * per_p);
  s.plane0 = tp * g.R;
  s.np = (int)least((int64_t)g.R, g.planes - s.plane0);
  s.r0 = (rem / g.tiles_w) * g.BH;
  s.nr = least(g.BH, g.H - s.r0);
  s.c0 = (rem % g.tiles_w) * g.BW;
  s.nc = least(g.BW, g.W - s.c0);
  s.sr0 = most(0, s.r0 - 2);
  s.sr1 = least(g.H, s.r0 + s.nr + 2);
  s.sc0 = most(0, s.c0 - 2);
  s.sc1 = least(g.W, s.c0 + s.nc + 2);
  s.wr0 = most(0, s.r0 - 1);
  s.wr1 = least(g.H, s.r0 + s.nr + 1);
  s.wc0 = most(0, s.c0 - 1);
  s.wc1 = least(g.W, s.c0 + s.nc + 1);
  return s;
}

// element index of p's 16-byte chunk offset: a span starting at p sits
// in shared memory at this element of its buffer, so 16-byte chunks of
// device memory map to 16-byte chunks of the buffer
template <typename T> __device__ __forceinline__ int shift_of(const T* p) {
  return (int)(((uintptr_t)p & 15) / sizeof(T));
}

// a span of cnt elements at p, cut at 16-byte boundaries: the whole
// chunks [lo, hi) go by bulk copy, the nhead elements before lo and the
// ntail after hi (chunks shared with the neighbouring spans) element by
// element. In shared memory element 0 sits at buf[shift_of(p)], so the
// chunks of both memories line up.
struct Span {
  uintptr_t a, lo, hi;
  int nhead, ntail;
  template <typename T>
  __device__ __forceinline__ Span(const T* p, int cnt) {
    a = (uintptr_t)p;
    const uintptr_t end = a + (uintptr_t)cnt * sizeof(T);
    lo = (a + 15) & ~(uintptr_t)15;
    hi = end & ~(uintptr_t)15;
    if (hi <= lo) lo = hi = end;  // no whole chunk: all element by element
    nhead = (int)((lo - a) / sizeof(T));
    ntail = (int)((end - hi) / sizeof(T));
  }
  __device__ __forceinline__ uint32_t bytes() const {
    return (uint32_t)(hi - lo);
  }
  // the shared-memory address of the chunk at lo in buf
  __device__ __forceinline__ uint32_t body(const void* buf) const {
    return hopper::smem_u32(buf) + (uint32_t)(lo - (a & ~(uintptr_t)15));
  }
};

// warp 1's share of a span: element k < nhead of the head, element
// cnt - ntail + (k - 16) of the tail for 16 <= k (at most 15 each)
template <typename T>
__device__ __forceinline__ int end_element(const Span& sp, int cnt) {
  const int k = (int)threadIdx.x - 32;
  if (k >= 0 && k < sp.nhead) return k;
  if (k >= 16 && k - 16 < sp.ntail) return cnt - sp.ntail + (k - 16);
  return -1;
}

// the loads of tile s into the stage buffers bufs[0..2] (x, y, dy), in
// two parts. load_bulk (thread 0): the whole chunks of the three spans by
// bulk copy, completing on bar; for a block (not one span) bar completes
// on the arrival alone. load_rest (after a barrier that follows
// load_bulk): warp 1 loads the spans' ends; a block is loaded element by
// element by all threads.
template <typename T>
__device__ __forceinline__ void load_bulk(const Geo& g, const Tile& s,
                                          const T* const src[3],
                                          T* const bufs[3], uint32_t bar) {
  if (!g.contiguous) {
    hopper::bar_expect(bar, 0);
    return;
  }
  const int cnt = s.np * (s.sr1 - s.sr0) * g.W;
  uint32_t bytes = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) bytes += Span(src[k], cnt).bytes();
  hopper::bar_expect(bar, bytes);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const Span sp(src[k], cnt);
    if (sp.bytes())
      hopper::bulk_load(sp.body(bufs[k]), (const void*)sp.lo, sp.bytes(),
                        bar);
  }
}

template <typename T>
__device__ __forceinline__ void load_rest(const Geo& g, const Tile& s,
                                          const T* const src[3],
                                          T* const bufs[3]) {
  if (g.contiguous) {
    if (threadIdx.x / 32 != 1) return;
    const int cnt = s.np * (s.sr1 - s.sr0) * g.W;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = end_element<T>(Span(src[k], cnt), cnt);
      if (e >= 0) bufs[k][shift_of(src[k]) + e] = src[k][e];
    }
  } else {  // a block of one plane (np == 1); src[k] at (sr0, sc0)
    const int pitch = s.sc1 - s.sc0;
    const int cnt = (s.sr1 - s.sr0) * pitch;
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const int i = (e / pitch) * g.W + e % pitch;
#pragma unroll
      for (int k = 0; k < 3; ++k) bufs[k][e] = src[k][i];
    }
  }
}

// store dx's span of cnt elements at dst from buf (element 0 at
// buf[shift_of(dst)]): thread 0 bulk-stores the whole chunks, warp 1 the
// ends; the caller has fenced the generic writes of buf and synced
template <typename T>
__device__ __forceinline__ void store_span(T* dst, int cnt, const T* buf) {
  if (threadIdx.x != 0 && threadIdx.x / 32 != 1) return;
  const Span sp(dst, cnt);
  if (threadIdx.x == 0) {
    if (sp.bytes())
      hopper::bulk_store((void*)sp.lo, sp.body(buf), sp.bytes());
    return;
  }
  const int e = end_element<T>(sp, cnt);
  if (e >= 0) dst[e] = buf[shift_of(dst) + e];
}

// a stage's work over a tile (np planes x rows x cols), cut into units of
// up to ch consecutive rows by kSeg columns, about one unit a thread: a
// thread walks its unit's rows in order and slides a window of three rows
// through registers, so it loads each row of its columns once
struct Units {
  int segs, nch, ch, n;
  uint64_t by_segs, by_nch;  // ceil(2^32 / segs), ceil(2^32 / nch)
  Units() = default;
  __device__ __forceinline__ Units(int np, int rows, int cols) {
    segs = (cols + kSeg - 1) / kSeg;
    nch = most(1, least(rows, kThreads / (np * segs)));
    ch = (rows + nch - 1) / nch;
    nch = (rows + ch - 1) / ch;
    n = np * nch * segs;
    by_segs = (0xffffffffull + segs) / segs;
    by_nch = (0xffffffffull + nch) / nch;
  }
  // unit u: its plane, first row and first column (from the stage's);
  // the quotients by multiplication, exact for u, segs, nch < 2^16
  __device__ __forceinline__ void at(int u, int& pl, int& r, int& c) const {
    const int rest = (int)((uint64_t)u * by_segs >> 32);
    pl = (int)((uint64_t)rest * by_nch >> 32);
    r = (rest - pl * nch) * ch;
    c = (u - rest * segs) * kSeg;
  }
};

__device__ __forceinline__ uint32_t pair16(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x5410);
}

// lanes of a and b (bf16x2) that compare equal: 0xffff, else 0 (NaN
// matches nothing; +0 == -0), as the f32 compare of the exact casts
__device__ __forceinline__ uint32_t eq_mask2(uint32_t a, uint32_t b) {
  __nv_bfloat162 u, v;
  memcpy(&u, &a, 4);
  memcpy(&v, &b, 4);
  return __heq2_mask(u, v);
}

// stage 1's window of x: three rows in slots 0..2, columns w0 - 1 .. w0 +
// kSeg, loaded from rows indexed by image column (the fill row outside
// the tile); colok bit j: column w0 - 1 + j is staged (in the image).
// first<top>(): the first-max offsets of the kSeg windows of the row in
// slot top + 1, the rows above and below in slots top and top + 2 (mod
// 3). The slots rotate, so that a step loads one row and moves none.
template <typename T> struct XRows;

template <> struct XRows<float> {
  float v[3][kSeg + 2];
  template <int S>
  __device__ __forceinline__ void load(const float* r, int w0,
                                       unsigned colok) {
#pragma unroll
    for (int j = 0; j < kSeg + 2; ++j)
      v[S][j] = (colok >> j & 1) ? r[w0 - 1 + j] : kFill;
  }
  template <int Top>
  __device__ __forceinline__ void first(const float* yr, int w0,
                                        int fst[kSeg]) const {
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const float yv = yr[w0 + k];
      int f0 = 9;
#pragma unroll
      for (int f = 8; f >= 0; --f)
        if (v[(Top + f / 3) % 3][k + f % 3] == yv) f0 = f;
      fst[k] = f0;
    }
  }
};

// bf16: pairs of neighbouring columns, two windows a compare (bf16x2).
// Out-of-image lanes hold NaN, which matches nothing, as float32's lowest
// value does in the f32 compare (no bf16 value equals it).
template <> struct XRows<__nv_bfloat16> {
  uint32_t pr[3][kSeg + 1];  // pr[s][j]: columns w0 - 1 + j, w0 + j
  template <int S>
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int w0,
                                       unsigned colok) {
    constexpr uint32_t kNaN2 = 0x7fc07fc0u;
    const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
    uint32_t v[kSeg + 2];
#pragma unroll
    for (int j = 0; j < kSeg + 2; ++j) v[j] = r[w0 - 1 + j];
#pragma unroll
    for (int j = 0; j <= kSeg; ++j) {
      const uint32_t keep = ((colok >> j & 1) ? 0xffffu : 0u)
                            | ((colok >> (j + 1) & 1) ? 0xffff0000u : 0u);
      pr[S][j] = (pair16(v[j], v[j + 1]) & keep) | (kNaN2 & ~keep);
    }
  }
  template <int Top>
  __device__ __forceinline__ void first(const __nv_bfloat16* yr, int w0,
                                        int fst[kSeg]) const {
    const uint16_t* y16 = reinterpret_cast<const uint16_t*>(yr);
#pragma unroll
    for (int p = 0; p < kSeg / 2; ++p) {
      const uint32_t yv = pair16(y16[w0 + 2 * p], y16[w0 + 2 * p + 1]);
      uint32_t f2 = 0x00090009u;
#pragma unroll
      for (int f = 8; f >= 0; --f) {
        const uint32_t m =
            eq_mask2(pr[(Top + f / 3) % 3][2 * p + f % 3], yv);
        f2 = (m & (uint32_t)f * 0x00010001u) | (~m & f2);
      }
      fst[2 * p] = f2 & 0xffff;
      fst[2 * p + 1] = f2 >> 16;
    }
  }
};

template <int N> using Slot = std::integral_constant<int, N>;

// rows h0 .. h1 - 1 of a unit, three a pass, each step given the slot
// of its row's upper neighbour (0, 1, 2, 0, ...) as a compile-time value
template <typename Step>
__device__ __forceinline__ void walk_rows(int h0, int h1, Step step) {
  int h = h0;
  for (; h + 3 <= h1; h += 3) {
    step(Slot<0>(), h);
    step(Slot<1>(), h + 1);
    step(Slot<2>(), h + 2);
  }
  if (h < h1) step(Slot<0>(), h);
  if (h + 1 < h1) step(Slot<1>(), h + 1);
}

template <typename T>
__device__ __forceinline__ void compute_tile(const Geo& g, const Tile& s,
                                             const T* __restrict__ x,
                                             const T* __restrict__ y,
                                             const T* __restrict__ dy,
                                             T* __restrict__ dx, T* xs,
                                             const T* ys, const T* gs,
                                             uint8_t* offs,
                                             const T* fill_area,
                                             const Units& un1,
                                             const Units& un2, bool borders) {
  const int64_t hw = (int64_t)g.H * g.W;
  const int pitch = s.sc1 - s.sc0;
  const int ppitch = (s.sr1 - s.sr0) * pitch;
  int shx = 0, shy = 0, shg = 0, shd = 0;
  const int64_t out0 = s.plane0 * hw + (int64_t)s.r0 * g.W;
  if (g.contiguous) {
    const int64_t e0 = s.plane0 * hw + (int64_t)s.sr0 * g.W;
    shx = shift_of(x + e0);
    shy = shift_of(y + e0);
    shg = shift_of(dy + e0);
    shd = shift_of(dx + out0);
  }
  // staged row r of plane pl, indexed by image column; the fill row
  // (indexed the same way) where r is outside [lo, hi)
  const T* fill_row = fill_area + 1 - s.sc0;
  auto row = [&](const T* buf, int pl, int r, int lo, int hi) {
    return (r >= lo && r < hi)
               ? buf + pl * ppitch + (r - s.sr0) * pitch - s.sc0
               : fill_row;
  };
  // the window offsets, bordered: (wrows + 2) x (wcols + 2) a plane, the
  // border kNoWindow, so that stage 2 reads them unchecked
  const int wrows = s.wr1 - s.wr0, wcols = s.wc1 - s.wc0;
  const int opitch = wcols + 2, oplane = (wrows + 2) * opitch;

  // stage 1: each window's first maximum
  {
    const int border = borders ? 2 * opitch + 2 * wrows : 0;
    for (int e = threadIdx.x; e < s.np * border; e += kThreads) {
      const int pl = e / border, b = e - pl * border;
      const int at =
          b < 2 * opitch
              ? (b < opitch ? b : (wrows + 1) * opitch + b - opitch)
              : (1 + (b - 2 * opitch) / 2) * opitch
                    + ((b & 1) ? wcols + 1 : 0);
      offs[pl * oplane + at] = kNoWindow;
    }
    const Units& un = un1;
    for (int u = threadIdx.x; u < un.n; u += kThreads) {
      int pl, r, c;
      un.at(u, pl, r, c);
      if (pl >= s.np) break;
      const int w0 = s.wc0 + c, h0 = s.wr0 + r;
      unsigned colok = 0;
#pragma unroll
      for (int j = 0; j < kSeg + 2; ++j)
        colok |= (unsigned)(w0 - 1 + j >= s.sc0 && w0 - 1 + j < s.sc1) << j;
      const T* xp = xs + shx;
      XRows<T> xw;
      xw.template load<0>(row(xp, pl, h0 - 1, s.sr0, s.sr1), w0, colok);
      xw.template load<1>(row(xp, pl, h0, s.sr0, s.sr1), w0, colok);
      uint8_t* op = offs + pl * oplane + (1 - s.wr0) * opitch
                    + (w0 - s.wc0 + 1);
      walk_rows(h0, least(h0 + un.ch, s.wr1), [&](auto top, int h) {
        constexpr int kTop = decltype(top)::value;
        xw.template load<(kTop + 2) % 3>(row(xp, pl, h + 1, s.sr0, s.sr1),
                                         w0, colok);
        int fst[kSeg];
        xw.template first<kTop>(row(ys + shy, pl, h, s.sr0, s.sr1), w0,
                                fst);
#pragma unroll
        for (int k = 0; k < kSeg; ++k)
          if (w0 + k < s.wc1) op[h * opitch + k] = (uint8_t)fst[k];
      });
    }
  }
  __syncthreads();

  // stage 2: each output gathers the windows whose first maximum it is
  T* dxs = xs + shd;  // x is dead: dx is staged in its buffer
  {
    const Units& un = un2;
    for (int u = threadIdx.x; u < un.n; u += kThreads) {
      int pl, r, c;
      un.at(u, pl, r, c);
      if (pl >= s.np) break;
      const int w0 = s.c0 + c, h0 = s.r0 + r;
      // the windows of three rows (slots, as in stage 1), columns w0 - 1
      // .. w0 + kSeg: their offsets (bordered) and cotangents
      const uint8_t* orow =
          offs + pl * oplane + (1 - s.wr0) * opitch + (w0 - s.wc0);
      int ov[3][kSeg + 2];
      float gv[3][kSeg + 2];
      auto load = [&](auto slot, int rr) {
        constexpr int kS = decltype(slot)::value;
        const T* gr = row(gs + shg, pl, rr, s.wr0, s.wr1);
#pragma unroll
        for (int j = 0; j < kSeg + 2; ++j) {
          ov[kS][j] = orow[rr * opitch + j];
          gv[kS][j] = to_f32(gr[w0 - 1 + j]);
        }
      };
      load(Slot<0>(), h0 - 1);
      load(Slot<1>(), h0);
      walk_rows(h0, least(h0 + un.ch, s.r0 + s.nr), [&](auto top, int h) {
        constexpr int kTop = decltype(top)::value;
        load(Slot<(kTop + 2) % 3>(), h + 1);
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          const int w = w0 + k;
          float acc = 0.0f;
          // p is at offset (dr, dc) of the window o = p - (dr, dc)
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            const int i = (kTop + 1 - (q / 3 - 1)) % 3;
            const int j = k + 1 - (q % 3 - 1);
            if (ov[i][j] == q) acc += gv[i][j];
          }
          if (w < s.c0 + s.nc) {
            if (g.contiguous)
              dxs[(pl * s.nr + h - s.r0) * g.W + w] = from_f32<T>(acc);
            else
              dx[s.plane0 * hw + (int64_t)h * g.W + w] = from_f32<T>(acc);
          }
        }
      });
    }
  }
  if (g.contiguous) {
    hopper::fence_proxy_async();  // dx's generic writes, then the bulk store
    __syncthreads();
    store_span(dx + out0, s.np * s.nr * g.W, xs);
  }
  __syncthreads();  // the offsets and the buffers are refilled next
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool3x3s1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            Geo g) {
  // [guard][2 stages][x, y, dy][buf_elems][offsets][fill area][2
  // mbarriers]: the guard keeps column -1 of a tile's first row inside
  // the allocation
  extern __shared__ __align__(16) unsigned char smem[];
  T* bufs = reinterpret_cast<T*>(smem + kGuardBytes);
  uint8_t* offs = smem + kGuardBytes + 6 * (size_t)g.buf_elems * sizeof(T);
  T* fill_area = reinterpret_cast<T*>(offs + g.offs_bytes);
  const uint32_t bars = hopper::smem_u32(fill_area + g.fill_elems);
  const int64_t tiles = g.tiles_p * g.tiles_h * g.tiles_w;
  int64_t t = blockIdx.x;
  if (t >= tiles) return;
  for (int e = threadIdx.x; e < g.fill_elems; e += kThreads)
    fill_area[e] = fill_value<T>();
  if (threadIdx.x == 0) {
    hopper::bar_init(bars, 1);
    hopper::bar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // x, y, dy of a stage; from tile s's first staged element
  auto stage_bufs = [&](int stage, T* (&b)[3]) {
    for (int k = 0; k < 3; ++k)
      b[k] = bufs + (size_t)(3 * stage + k) * g.buf_elems;
  };
  auto sources = [&](const Tile& s, const T* (&src)[3]) {
    const int64_t e0 =
        s.plane0 * g.H * g.W + (int64_t)s.sr0 * g.W + s.sc0;
    src[0] = x + e0;
    src[1] = y + e0;
    src[2] = dy + e0;
  };
  // thread 0 starts a tile's bulk copies; all threads (a block) or warp 1
  // (a span's ends) load the rest
  const bool loads_rest = !g.contiguous || threadIdx.x / 32 == 1;
  auto load = [&](int64_t tile, int stage, bool bulk) {
    if (!(bulk ? threadIdx.x == 0 : loads_rest)) return;
    const Tile s = tile_of(g, tile);
    const T* src[3];
    T* b[3];
    sources(s, src);
    stage_bufs(stage, b);
    if (bulk)
      load_bulk(g, s, src, b, bars + 8 * stage);
    else
      load_rest(g, s, src, b);
  };
  load(t, 0, true);
  load(t, 0, false);
  Units un1, un2;
  uint32_t parity = 0;  // bit k: the parity of stage k's next phase
  for (int stage = 0; t < tiles; t += gridDim.x, stage ^= 1) {
    const int64_t next = t + gridDim.x;
    // into the other stage's buffers, once the bulk store of dx from
    // them (a tile back) has read them
    if (next < tiles && threadIdx.x == 0) {
      hopper::bulk_wait_read();
      load(next, stage ^ 1, true);
    }
    hopper::bar_wait(bars + 8 * stage, parity >> stage & 1);
    parity ^= 1u << stage;
    __syncthreads();  // this tile's ends; thread 0's wait for the store
    if (next < tiles) load(next, stage ^ 1, false);
    T* b[3];
    stage_bufs(stage, b);
    const Tile s = tile_of(g, t);
    // whole planes: one geometry (R planes a tile; the last tile's units
    // past its planes idle), so one cut into units and the offsets'
    // borders once
    const bool plan = t == blockIdx.x || !g.whole;
    if (plan) {
      const int np = g.whole ? g.R : s.np;
      un1 = Units(np, s.wr1 - s.wr0, s.wc1 - s.wc0);
      un2 = Units(np, s.nr, s.nc);
    }
    compute_tile(g, s, x, y, dy, dx, b[0], b[1], b[2], offs, fill_area, un1,
                 un2, plan);
  }
  if (threadIdx.x == 0) hopper::bulk_wait();  // before the CTA's exit
}

template <typename T>
int launch(const void* x, const void* y, const void* dy, void* dx, int N,
           int C, int H, int W, cudaStream_t st) {
  Geo g;
  g.planes = (int64_t)N * C;
  g.H = H;
  g.W = W;
  if (g.planes <= 0 || H <= 0 || W <= 0) return 0;
  const int64_t elt = sizeof(T), plane = (int64_t)H * W * elt;
  if (3 * plane <= kPlaneStageBytes) {  // runs of whole planes
    // the run of planes (within the cap) whose units keep the threads
    // busiest (in steps of 2 %), the largest of those (the longest units,
    // the fewest tiles); units cut as Units cuts them
    const int64_t segs = (W + kSeg - 1) / kSeg;
    const int64_t cap = least(kPlaneStageBytes / (3 * plane), g.planes);
    int64_t best = -1;
    for (int64_t r = 1; r <= cap; ++r) {
      const int64_t nch =
          most((int64_t)1, least((int64_t)H, kThreads / (r * segs)));
      const int64_t ch = (H + nch - 1) / nch;
      const int64_t n = r * ((H + ch - 1) / ch) * segs;
      const int64_t rounds = (n + kThreads - 1) / kThreads;
      const int64_t busy = 50 * n / (rounds * kThreads);
      if (busy >= best) {
        best = busy;
        g.R = (int)r;
      }
    }
    g.BH = H;
    g.BW = W;
  } else {
    g.R = 1;
    const int64_t rows = kBandStageBytes / (3 * W * elt) - 4;
    if (rows >= kMinBandRows) {  // bands of whole rows
      g.BH = (int)least(rows, (int64_t)H);
      g.BW = W;
    } else {  // blocks, staged element by element
      g.BH = least(kBlockRows, H);
      g.BW = (int)least(
          most(kBandStageBytes / (3 * (g.BH + 4) * elt) - 4, (int64_t)1),
          (int64_t)W);
    }
  }
  g.contiguous = g.BW == W;
  g.whole = g.contiguous && g.BH == H;
  g.tiles_p = (g.planes + g.R - 1) / g.R;
  g.tiles_h = (H + g.BH - 1) / g.BH;
  g.tiles_w = (W + g.BW - 1) / g.BW;
  if ((int64_t)g.tiles_h * g.tiles_w > 0x7fffffff) return -3;
  const int64_t staged =
      (int64_t)g.R * least(H, g.BH + 4) * least(W, g.BW + 4);
  g.buf_elems = (int)(((staged * elt + 16 + 15) / 16) * 16 / elt);
  const int64_t windows = (int64_t)g.R * (least(H, g.BH + 2) + 2)
                          * (least(W, g.BW + 2) + 2);
  g.offs_bytes = (int)((windows + 8 + 15) / 16 * 16);
  g.fill_elems = least(W, g.BW + 4) + 8;
  g.fill_elems = (int)((g.fill_elems * elt + 15) / 16 * 16 / elt);
  const size_t smem = kGuardBytes + 6 * (size_t)g.buf_elems * elt
                      + g.offs_bytes + g.fill_elems * elt + 16;

  auto kernel = maxpool3x3s1_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return -4;
  const int64_t tiles = g.tiles_p * g.tiles_h * g.tiles_w;
  const int grid = (int)least(tiles, (int64_t)sms * per_sm);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x, y, dy, dx: contiguous (N, C, H, W) of
// one dtype (y the forward's output). Returns 0, or a CUDA error code
// (negative: unsupported dtype -2, grid -3, no CTA fits an SM -4).
extern "C" int bigdl_maxpool3x3s1_bwd(int dtype, const void* x, const void* y,
                                      const void* dy, void* dx, int N, int C,
                                      int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, dy, dx, N, C, H, W, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, dy, dx, N, C, H, W, st);
  return -2;
}

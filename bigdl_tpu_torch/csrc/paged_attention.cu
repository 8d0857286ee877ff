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
// The C entry picks one of three designs by dtype and shape alone
// (route_of; ops/paged_attention.kernel_route mirrors it, and the entry
// reports the route it took so the wrapper can hold the mirror to it):
// past head dim kRowOnlyPast (256) a bf16 call (G <= 64, rows of a
// 16-byte multiple, P <= kTcMaxPages; decode too) takes the tensor-core
// prefill with its output's columns
// sliced (route "tc_sliced", `paged_prefill_sliced_tc_kernel`, D a
// runtime value), every other call there the row-tile kernel
// (`paged_attention_wide_kernel`, D a runtime value, up to wide_max_d;
// past it the route "row_sliced", `paged_attention_sliced_kernel`, its
// output columns sliced, so every multiple of 64 runs); otherwise a call
// whose T·G query
// rows of a kv head fit one tile (T·G <= kSplitRows, every decode step)
// takes the split-KV decode kernel; a bf16 call with more rows
// (prefill, and decode past 16 rows: Falcon-7B's 71 heads over one kv
// head) takes `paged_prefill_tc_kernel` at any page size and any G,
// unless P > kTcMaxPages (4096). So the row-tile kernel keeps f32
// pools, tables wider than 4096 entries, unaligned rows and, past D
// 256, G > 64. Every route takes any page size, G and table
// width. No call reroutes after a failed map or launch: the entry
// returns the error.
//
// Every head dim D >= 1 runs, padded inside the kernels: the pools are
// the whole cache, and a zero-padded copy of them on each step would
// cost more than the attention. A call carries two head dims (Call): the
// true one, Dt, for every stride, extent and store, and the built one,
// D = built_dim(Dt) (32, 64, 128, 192 or 256, past 256 the next multiple
// of 64), which picks the instantiation and lays out shared memory and
// the split workspace. Each kernel reads Dt columns of q and K/V and
// holds zeros from Dt to D: the split and row-tile kernels store zeros
// there as they stage, the tensor-core kernel's maps have a global
// extent of Dt, so TMA fills its 64-column boxes past it (as at D 32);
// zero columns add exact zeros to every q·k, and the scale is the
// caller's (the true D's). Output columns past Dt are never stored.
// Where Dt·elt is no multiple of 16 bytes (bf16 Dt % 8, f32 Dt % 4), a
// pool row is not 16-byte aligned: the split kernel's copies and a TMA
// map's strides need that, so route_of sends such calls to the row-tile
// kernels, which stage those rows element by element. The split and
// row-tile kernels take a PAD template flag, set where Dt < D: at a built
// head dim the padding's guards and branches compile away, and the
// kernel is the one it was (as run-time branches they cost those kernels
// up to 1.23x their time at built head dims; with the flag, bit-equal at
// 0.99-1.02x: scripts/paged_ab.py, one NVIDIA H100 80GB HBM3, 700 W).
// The flag alone keeps load_slots and the split kernel's chunk load as
// they were (one loop each, guarded by !PAD: row-tile 0.998-1.002x,
// split 0.996-1.010x the parent, bit-equal). The sliced kernel keeps a
// copy of its unpadded load beside the padded one: without it the sliced
// cases ran 1.14-1.22x, with the padded load's guards on !PAD still
// 1.06-1.09x.
//
// paged_prefill_tc_kernel (bf16 prefill, tensor cores):
// - Bound: prefill of a 512-token bucket (H 8, KV 2, D 128) does 0.54
//   GFLOP on 3.7 MB (2.1 of it the f32 output): some 150 operations a
//   byte, so its roofline bound is the bytes' 1.1 µs, twice the tensor
//   cores' 0.54 µs, and neither is near on the CUDA cores. What a CTA
//   waits on is latency: its chain of 1-8 key tiles, each a TMA load,
//   two dependent products and the softmax between them.
// - One CTA = one consumer warpgroup of 64 folded query rows of one (row
//   b, kv head) and one producer warp. Folded row R of a kv head is
//   (query column, head) = divmod(R, F), head h·G + R % F, F the fold
//   (fold_of); tile y holds rows 64·y to 64·y + 63. Grid (B·KV,
//   ceil(T·F / 64)).
//   - G <= 64: F = gp, G padded to the smallest power of two >= G (G
//     itself where 64 % G == 0), as the TPU kernel folds G, padded to a
//     multiple of 8, into the matmul's rows. Q lands by one TMA load per
//     64-dim chunk from a 4-D (D, H, T, B) map with a box of (64, gp,
//     64/gp, 1): at (d0, h·G, t0, b) the box's rows are exactly the
//     folded rows in order, [64 rows][128 bytes] with 128-byte swizzle,
//     the wgmma operand layout; columns past T read as zeros within row
//     b. Rows with R % gp >= G hold the next group's heads (or zeros past
//     H): computed, finite, never written.
//   - G > 64: F = G, a flat fold, no padding (Falcon-7B: 71 query heads
//     over one kv head). A tile spans at most two query columns, whose
//     rows lie in two runs of heads where KV > 1, which no one box
//     holds: the consumer warpgroup loads Q itself, once a CTA (64 x D
//     bf16, 16-byte loads, 4 a thread at D 64, all issued before the
//     first store: one load at a time took Falcon-7B's prefill 0.02518
//     ms and its decode 0.01997, together 0.02322 and 0.01878 on one
//     NVIDIA H100 80GB HBM3, scripts/paged_prefill_timeline.py), into
//     the layout TMA's 128-byte swizzle gives (16-byte chunk j of row r
//     at j ^ (r % 8) of its 128-byte row), zeros past T and D, then
//     fences the async proxy and meets the other consumers at a named
//     barrier before its first wgmma. Rows past T·G are computed on
//     zeros, never written. A decode step (T 1) is ceil(G / 64) CTAs of
//     (row, kv head): two at G 71, the second with 7 real rows.
//   - Headroom (ptxas and the layout below, one NVIDIA H100 80GB HBM3):
//     one kernel serves both folds, so G > 64 holds what G <= 64 holds.
//     D 64: 118 registers, 74,832 + 4·P bytes of shared memory
//     (8 KB of Q, 4 stages of 16 KB, barriers, page ids), so 3 CTAs an
//     SM (registers and shared memory both); D 256, the widest: 228
//     registers (212 before the flat fold), 164,912 + 4·P bytes, 1 CTA
//     an SM. No spills.
// - Keys come in tiles of 64 straight off the pools through the block
//   table. Each page is padded to S8 = ceil(S / 8)·8 slots: slot s of
//   page j is padded key j·S8 + s, and tiles walk padded keys. Each pool
//   is a (D, KV, S, num_pages) map with boxes of (64, 1, br, 1), br the
//   largest of 64/32/16/8 dividing S8, so a tile is 64 / br boxes per
//   chunk, each at (d0, h, slot, table[b, page]), landing at its rows of
//   the tile as a whole 1024-byte swizzle atom. Where S % 8 != 0 a
//   page's last box reaches past slot S - 1, and TMA fills those rows
//   with zeros; the consumer scores them -inf (they are no keys, so each
//   weighs exactly 0), in every tile, and compares the logical key j·S +
//   s with the query position. The CTA stages its row's page ids (at
//   most kTcMaxPages) in shared memory with q_start before the first
//   load, so no TMA issue waits on a DRAM read.
// - Pages whose first slot lies past the CTA's last query position (or
//   past P) are never read: their slots, in the one tile that can have
//   them (the last), are boxes at page -1, out of bounds, which TMA
//   fills with zeros without reading memory. They lie past every query
//   of the CTA, so they are masked with the keys past a query, and their
//   V rows are finite, as P·V needs (0 x NaN is NaN): a NaN in a page
//   past the row's last query never reaches the output. Keys past a
//   query, inside a loaded page or not, score the finite -1e9; those in
//   a loaded page are read, as the TPU kernel reads them.
// - S = Q·Kᵀ is `wgmma` m64n64k16 with both operands in shared memory
//   (K-major); P·V takes P from the accumulator's registers, rounded to
//   bf16 at the running max (the TPU kernel's rounding point), and V
//   MN-major from shared memory: no transposed copy. Online softmax in
//   f32 registers, in base 2 (ex2.approx); scores are masked element-wise
//   only in tiles that reach past the CTA's first query position, or in
//   every tile where pages are padded.
// - K/V tiles run through a ring of 4 stages (2 past D 128: at D 192
//   four would take 24 KB of Q + 4 x 48 KB + the page ids) with full/empty
//   mbarriers. The producer warp issues every tile's boxes, a lane a box
//   (one TMA issue costs some 100 cycles: a tile of 4 pages at D 128 is
//   16 boxes), and refills a stage as soon as the 4 consumer warps
//   release it, so only the first tile's issue is on the consumers'
//   path. The tiles with the most keys are launched first. Output f32
//   straight from the accumulator; padded rows and rows past T are not
//   written.
// - Tensor maps are encoded on the host per call (the pool pointer
//   changes with each layer; Q's only where G <= 64); at D 32 the
//   64-wide boxes reach past D and fill with zeros, as flash's do.
//
// paged_prefill_sliced_tc_kernel<OWN> (bf16 past D 256, prefill and
// decode, tensor cores, the output's columns sliced):
// - Past D 256 the kernel above has no registers left: an f32
//   accumulator of 64 rows costs 32 registers a thread per 64-column
//   chunk, 128 at D 256 beside s (32) and P (16). So a CTA owns one
//   slice of OWN <= 4 output chunks (256 columns), the fewest slices, as
//   even as they come (sl_own, as flash_attention.cu's sliced forward:
//   D 320 3 + 2 chunks, 512 4 + 4, 576 3 x 3, 1024 4 x 4, 1856 8 slices
//   of 4, the last holding 3 chunks of TMA's zeros, 2048 8 x 4); chunks
//   past D are never stored. Grid (B·KV, ceil(T·F / 64), slices), the
//   fold of the kernel above (F = gp, G <= 64: Q by one TMA box a
//   chunk), one consumer warpgroup of 64 folded rows (kSlRows),
//   the most keys first. A copy with two (128 rows sharing each K chunk,
//   half the CTAs, a producer warpgroup with setmaxnreg 40 / 232, no
//   spills) took 1.11-1.43x its time at every case, decode and the
//   512-token prefill too (scripts/paged_ab.py --two-warpgroups, one
//   NVIDIA H100 80GB HBM3, 700 W): the grids are under a wave of the
//   SMs, so halving them halves the parallel K streams.
// - S = Q·Kᵀ over 64-key tiles of the padded slot space sums over all
//   of D in 64-column chunks (m64n64k16 x 4 a chunk, both operands
//   K-major [64][64] boxes), a chunk a step, in the same order in every
//   slice, so every slice forms the same scores, m and l; step t - 1's
//   group overlaps step t's (wgmma.wait_group 1) before its stage is
//   released. Masks, p rounded to bf16 at the running max and P·V (OWN
//   m64n64k16 a K step, V MN-major) as in the kernel above.
// - A producer warp streams step t's K chunk (64 / br boxes of (64, 1,
//   br, 1) at each page id, staged in shared memory first, page -1 past
//   the CTA's last query) through a ring of up to kSlMaxStages
//   full/empty stages; Q's chunk c comes with step c into a place of its
//   own where all of Q fits (resident: nc x 8 KB beside the V slice, the
//   page ids and kSlMinStages stages, D <= 1280 at short tables), else
//   with every step's K chunk (16 KB a stage). A second producer warp
//   loads each key tile's V slice (OWN chunks) once the previous tile's
//   P·V has read the buffer. 192 threads: no setmaxnreg (255 registers
//   a thread fit).
// - Bound: bytes (q, the K/V rows the queries reach, the f32 output; at
//   q (2,96,4,2048) 13 MB, 3.9 µs at 3.35 TB/s), the tensor cores' 989
//   TFLOP/s far behind. The cost of the slices: each recomputes S, so a
//   call does slices + 1 half-products where one D-wide CTA would do 2
//   (3 at D 512, 9 at D 2048), and re-reads Q and K from L2 once a
//   slice; the row-tile kernels it replaces scored on the CUDA cores,
//   each K/V row staged once per 8 query rows. At q (2,96,4,D), D
//   512-2048, it takes 0.020-0.053 ms, 0.35-0.37x SDPA's time and
//   0.17-0.25x the row-tile kernels' (scripts/paged_ab.py, chip_smoke.py;
//   one NVIDIA H100 80GB HBM3, 700 W), at 5-7 % of its bound. What sets
//   the pace is each CTA's serial chain of (key tile, chunk) steps: the
//   times fit 8.7 us a call + 0.69 us a step of the CTA with the most
//   keys, within 7 %. Not the K bytes (no K loads: 0.82-0.96x), not the
//   TMA issues (a box a 64-slot chunk: the same), not the grid (at D
//   512, B 8's 96 CTAs take 1.03x B 2's 24) (scripts/paged_ab.py --fit,
//   --no-k-loads, --one-box; the same card).
// - Headroom (ptxas, one NVIDIA H100 80GB HBM3): OWN 4 205 registers,
//   OWN 3 175, no spills; shared memory 230,752 bytes at D 512 (Q
//   resident, 16 stages), 1 CTA an SM.
//
// paged_attention_kernel (f32 pools, P > 4096; past D 256 its wide
// form, and past the wide form's cap its column-sliced form):
// - One CTA of 4 warps per (row b, kv head, tile of query rows). The G
//   query heads that share a kv head fold into the tile's rows (row r is
//   query column r / G, head r % G), as the TPU kernel folds them into the
//   matmul's row dimension; the card needs no padding of G.
// - The TPU grid's sequential page axis (scratch carried across pages)
//   becomes a loop over the row's pages inside the CTA. The CTA reads the
//   block table and q_start itself (no scalar prefetch).
// - K/V are staged in shared memory with cp.async in chunks of C slots of
//   a page, double buffered, so the next chunk's load overlaps this
//   chunk's arithmetic. C (row_chunk_slots, on the host) is the whole
//   page where 4·S·D·bytes fit the 227 KB a block may use (beside the
//   wide kernel's q and accumulator, row_fixed_bytes), so such pages
//   run the loop they always ran, else the most slots that fit in a
//   multiple of kKeyChunk: 112 of a 256-slot f32 page at D 128, 24 at
//   f32 D 512. Keys are scored kKeyChunk at a time from each multiple of
//   kKeyChunk of the page either way, so the arithmetic does not depend
//   on C.
// - Chunks whose first slot lies past the tile's last query position
//   (and every page past it) are never loaded: a short row in a long
//   table reads only its own keys.
// - Each warp owns 4 query rows; each lane owns D/32 of the head dims
//   (q and the accumulator in registers). Scores are f32 dot products
//   finished with warp shuffles; the running max, sum and accumulator
//   are f32 (online softmax). P·V takes p rounded to the pool dtype, as
//   the TPU kernel does. Output f32.
// - Past D 256 (kRowOnlyPast) `paged_attention_wide_kernel` runs the
//   same loop with D a runtime value: 2 rows a warp, whose q and f32
//   accumulator (64·D bytes a CTA) sit in shared memory beside the
//   chunks, lane l owning columns 32c + l, so a warp reads a K or V row
//   in consecutive words. It takes every multiple of 64 up to
//   wide_max_d: the smallest chunk (8 slots of K and V, double buffered,
//   32·D·elt bytes) must fit beside them in 232,448 bytes, so D <= 1152
//   for f32 pools and D <= 1792 for bf16 ones.
// - Past wide_max_d `paged_attention_sliced_kernel` runs the same
//   arithmetic in the same order with shared memory that does not grow
//   with D: grid (B·KV, row tiles, ceil(D / 512)), a CTA's f32
//   accumulator holding its 8 rows' slice of 512 columns (the last
//   slice narrower). Each score still sums over all of D: q and the
//   8-key group's K rows come in 512-column pieces through a 2-stage
//   cp.async ring, lane l adding columns 32c + l in the wide kernel's
//   order, so every slice forms the same scores, m and l; V rows of the
//   slice only are staged, a group at a time, double buffered. 64 KB of
//   shared memory for bf16 pools, 112 KB for f32, at any D; the cost is
//   the scores recomputed once a slice (4 times at D 2048). Calls at or
//   under wide_max_d keep the wide kernel: forced there, the sliced form
//   gives the same bits at 1.02-1.69x its time (scripts/paged_ab.py
//   --sliced, one NVIDIA H100 80GB HBM3, 700 W, D 320-1792: bf16
//   1.2-1.4x, 1.02x at the D 1024 decode; f32 1.2-1.7x), as it stages q
//   again with each 8-key group and syncs once a group. In the wide
//   kernel, lanes that owned D/32 contiguous columns (the layout below
//   D 256) would read K and V 2·D/32 bytes apart, 8 words at bf16 D 512,
//   so a warp would hit 4 banks: measured, that took 2.1× its time at D
//   512 (and 1.03× at D 320, whose 5-word stride spreads; PERF.md §6).
// - It does its operations on the CUDA cores: f32 pools have no other
//   exact route, and the geometries the tensor-core kernels do not tile
//   are rare ones. Past D 256 it keeps f32, G > 64, unaligned rows and
//   tables past 4096 entries; bf16 prefill and decode went to the
//   sliced tensor-core kernel.
//
// paged_decode_split_kernel (decode, flash-decoding):
// - Bound: a decode step does ~4·D operations per key and head, far under
//   the ~295 operations a byte at which the tensor cores matter, so it is
//   bound by the bytes of the K/V pages its rows reach — and, at serving
//   sizes (a few MB), by latency: one CTA per (row, kv head) walking its
//   pages one at a time leaves most of the 132 SMs idle.
// - So the key range is cut into splits of `pps` pages, chosen on the
//   host from host integers alone (ops/paged_attention.py,
//   decode_split_pages): grid (B·KV, ceil(P / pps)). A CTA whose split
//   starts past its row's last key (q_start + T - 1) exits at once; the
//   others read only keys up to that last key.
// - A CTA reads q_start, its split's page ids and q together, then
//   issues cp.async loads of every key row of its split (K and V,
//   one kv head, 16-byte copies) before it waits, when the split fits
//   shared memory (one stage); a longer split runs in chunks through two
//   stages, the next chunk in flight while this one is scored. Keys are
//   staged row by row through the block table, so any page size works
//   (a chunk may hold part of a page or several pages).
// - Scores: two threads a key, each half of D (lanes l and l + 16 of a
//   warp, joined by one shuffle), two keys a thread; a thread reads its
//   half of each K row once in 16-byte vectors (rows padded by 16 bytes,
//   so 8 lanes reading 8 rows at one offset hit 8 distinct bank groups)
//   and forms the dot products of all T·G query rows of the kv head
//   against it (q in shared memory as f32, read by broadcast). No per-key
//   warp reduction.
// - Softmax: one warp per query row takes the chunk's max and sum once a
//   chunk (online across chunks); p is rounded to the pool dtype before
//   P·V, masked keys score the finite -1e9, as in the prefill kernel.
// - P·V: a thread owns one 16-byte slice of D for all rows and a strided
//   subset of the chunk's keys, so each V vector is read once and feeds
//   every row; slices are summed over threads once, at the end. Where a
//   row's slices do not divide the 128 threads (D 192: 24 of bf16, 48 of
//   f32), the threads past the last whole group sit P·V out.
// - Each CTA writes an f32 partial per (query row, split): running max m,
//   sum l and the unnormalised accumulator, to a workspace the wrapper
//   allocates. The last live split CTA of a (row, kv head) to finish —
//   counted with an atomic counter per (row, kv head), the live splits
//   counted from q_start on the card — merges the row's partials:
//   o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, and resets its
//   counter to 0 for the next call.
// - The merge runs in the last CTA rather than a second kernel: a separate
//   merge kernel took 4.7 µs of a 21 µs call at the serving decode shapes
//   on an H100, plus its launch; the counters are the price: B·KV ints,
//   zeroed once by the wrapper and left zeroed by every call.
// - The kernel allocates nothing; the Python wrapper allocates `out`, the
//   workspace and the counters and checks shapes, dtypes, contiguity and
//   alignment.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"       // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyChunk = 8;       // keys scored per online-softmax update
constexpr float kMask = -1e9f;     // finite mask value, as the TPU kernel
constexpr int kSmemMax = 232448;   // bytes of shared memory one block may use
// the split-KV kernel and the tensor-core prefill of a compile-time D
// are built up to this head dim; past it a call runs the sliced
// tensor-core prefill or the row-tile kernel (route_of)
constexpr int kRowOnlyPast = 256;
constexpr int kWideRpw = 2;                    // query rows a wide warp
constexpr int kWideRows = kWarps * kWideRpw;   // query rows a wide CTA

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage slots [slot0, slot0 + n) of physical page `page`, kv head `h`,
// of both pools into smem: n rows of D elements each (the built head
// dim, a compile-time constant where the caller's is), rows contiguous,
// the pools' Dt columns copied and the D - Dt past them zeros. Rows of
// Dt·elt bytes a multiple of 16 go in 16-byte cp.async copies, other
// rows are not 16-byte aligned in the pool and go element by element
// (plain loads and stores, route "row" only). PAD as the kernels': where
// it is false, Dt == D and the guards compile away
template <typename T, bool PAD>
__device__ __forceinline__ void load_slots(T* ks, T* vs, const T* kp,
                                           const T* vp, int64_t page,
                                           int slot0, int n, int h, int S,
                                           int KV, int D, int Dt) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  const int64_t base =
      (page * S + slot0) * KV * Dt + static_cast<int64_t>(h) * Dt;
  if (!PAD || Dt % kVec == 0) {
    const int per_slot = D / kVec, valid = Dt / kVec;
    for (int c = threadIdx.x; c < n * per_slot; c += kThreads) {
      const int s = c / per_slot, v = c % per_slot, w = v * kVec;
      if (!PAD || v < valid) {
        const int64_t g = base + static_cast<int64_t>(s) * KV * Dt + w;
        cp_async16(ks + s * D + w, kp + g);
        cp_async16(vs + s * D + w, vp + g);
      } else {
        *reinterpret_cast<uint4*>(ks + s * D + w) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + s * D + w) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int c = threadIdx.x; c < n * D; c += kThreads) {
      const int s = c / D, w = c % D;
      const int64_t g = base + static_cast<int64_t>(s) * KV * Dt + w;
      ks[s * D + w] = w < Dt ? kp[g] : T{};
      vs[s * D + w] = w < Dt ? vp[g] : T{};
    }
  }
}

// CHUNKS: pages in chunks of C < S slots; else whole pages (C == S), the
// loop the kernel ran before it streamed chunks (its own instantiation,
// so a page that fits runs it as it ran). PAD: the pools' head dim
// dt_arg lies below D (zeros staged past it, stores stopped at it); an
// instantiation of its own, so a head dim the kernel is built for runs
// the code it ran before
template <typename T, int D, int RPW, bool CHUNKS, bool PAD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ table,
                       const int* __restrict__ q_start,
                       float* __restrict__ out, int T_, int H, int KV,
                       int dt_arg, int S, int P, int C, float scale) {
  constexpr int kDpl = D / 32;           // head dims per lane
  const int Dt = PAD ? dt_arg : D;
  constexpr int kRows = kWarps * RPW;    // query rows per CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);   // [2][K|V][C][D]

  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int G = H / KV;
  const int rows_total = T_ * G;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qs = q_start[b];
  const int q_last = qs + (min(row0 + kRows, rows_total) - 1) / G;
  // the row's pages in chunks of Cs slots, cpp a page, in order. The
  // chunks whose first key lies at or before q_last hold every key any
  // row here may attend; the rest (and every page past q_last's) are
  // never loaded
  const int Cs = CHUNKS ? C : S;
  const int cpp = CHUNKS ? (S + Cs - 1) / Cs : 1;
  const int last_page = min(P - 1, q_last / S);
  const int n_chunks =
      !CHUNKS ? min(P, q_last / S + 1)
      : P > 0 ? last_page * cpp + min(cpp, (q_last - last_page * S) / Cs + 1)
              : 0;

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
    // q, the pools and out have rows of Dt; columns past Dt are zeros
    obase[i] = ((static_cast<int64_t>(b) * T_ + t) * H + head) * Dt +
               lane * kDpl;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDpl; ++d) {
      qr[i][d] = live[i] && (!PAD || lane * kDpl + d < Dt)
                     ? to_f32(q[obase[i] + d]) : 0.f;
      acc[i][d] = 0.f;
    }
  }

  const int* row_table = table + static_cast<int64_t>(b) * P;
  // chunk u (slots [s0, s0 + Cs) of page j) into buffer u & 1
  auto load = [&](int u, int j, int s0) {
    T* const dst = buf + (u & 1) * 2 * Cs * D;
    load_slots<T, PAD>(dst, dst + Cs * D, kp, vp, row_table[j], s0,
                       CHUNKS ? min(Cs, S - s0) : S, h, S, KV, D, Dt);
  };
  if (n_chunks > 0) load(0, 0, 0);
  cp_async_commit();
  // chunk u is slots [slot0, slot0 + Cs) of page j, stepped along with
  // u (whole pages: page u, slot 0)
  int j = 0, slot0 = 0;
  for (int u = 0; u < n_chunks; ++u) {
    T* const ks = buf + (u & 1) * 2 * Cs * D;
    T* const vs = ks + Cs * D;
    const int page = CHUNKS ? j : u, first = CHUNKS ? slot0 : 0;
    const bool wrap = !CHUNKS || first + Cs >= S;   // the next opens a page
    const int j_next = wrap ? page + 1 : page;
    const int s_next = wrap ? 0 : first + Cs;
    if (u + 1 < n_chunks) load(u + 1, j_next, s_next);
    cp_async_commit();
    cp_async_wait_prev();                // chunk u has landed
    __syncthreads();
    // keys [key0, key0 + n) of the row: groups of kKeyChunk start at
    // multiples of kKeyChunk within the page, as Cs is one (or S)
    const int n = CHUNKS ? min(Cs, S - first) : S, key0 = page * S + first;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (!live[i]) continue;            // warp-uniform
      for (int c = 0; c < n; c += kKeyChunk) {
        float s[kKeyChunk];
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) {
          float part = 0.f;
          if (c + kk < n) {
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
          const int kpos = key0 + c + kk;
          s[kk] = c + kk >= n        ? -INFINITY   // past the chunk: no key
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
          if (c + kk < n) {
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
    __syncthreads();                     // buffer u & 1 is refilled next
    j = j_next;
    slot0 = s_next;
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int d = 0; d < kDpl; ++d)
      if (!PAD || lane * kDpl + d < Dt) out[obase[i] + d] = acc[i][d] / l[i];
  }
}

// shared memory a row-tile CTA keeps beside its K/V chunks: none up to
// kRowOnlyPast (q and the accumulator live in registers), past it q and
// the f32 accumulator of the wide kernel's kWideRows rows (f32 each)
__host__ __device__ constexpr int row_fixed_bytes(int D) {
  return D > kRowOnlyPast ? 2 * kWideRows * D * 4 : 0;
}

// the largest head dim, a multiple of 64, that the wide kernel takes for
// pools of elt-byte elements: its smallest chunk (kKeyChunk slots of K
// and V, double buffered: 4·8·D·elt bytes) beside q and the accumulator
// (64·D bytes) within kSmemMax: 232448 / (128 + 64) -> 1152 for f32,
// 232448 / (64 + 64) -> 1792 for bf16
constexpr int wide_max_d(int elt) {
  return kSmemMax / (4 * kKeyChunk * elt + 2 * kWideRows * 4) / 64 * 64;
}

// output columns a CTA of the row-tile kernel past wide_max_d owns, and
// the width of the column pieces it stages q and K in
constexpr int kSliceCols = 512;

// shared memory of that kernel, whatever D: 2 stages of q (kWideRows
// rows) and K (kKeyChunk rows) pieces and 2 groups of V rows of the
// slice, elt-byte elements, beside the f32 accumulator of its rows:
// 48·512·elt + 16 KB (64 KB bf16, 112 KB f32)
__host__ __device__ constexpr int sliced_smem_bytes(int elt) {
  return (2 * (kWideRows + kKeyChunk) + 2 * kKeyChunk) * kSliceCols * elt +
         kWideRows * kSliceCols * 4;
}

// slots of a row-tile chunk: the whole page where its K and V, double
// buffered (4·S·D·elt bytes), fit a block's shared memory beside the
// CTA's fixed part (row_fixed_bytes), else the most that do in a
// multiple of kKeyChunk; past wide_max_d one 8-key group (the sliced
// form stages a group at a time)
int row_chunk_slots(int D, int S, int elt) {
  if (D > wide_max_d(elt)) return S < kKeyChunk ? S : kKeyChunk;
  const int fit = (kSmemMax - row_fixed_bytes(D)) / (4 * D * elt);
  return S <= fit ? S : fit / kKeyChunk * kKeyChunk;
}

template <typename T, int D, int RPW>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* q_start, float* out, int B, int T_, int H, int KV,
           int Dt, int S, int P, float scale, cudaStream_t stream) {
  constexpr int kRows = kWarps * RPW;
  const int rows_total = T_ * (H / KV);
  const dim3 grid(B * KV, (rows_total + kRows - 1) / kRows);
  const int C = row_chunk_slots(D, S, sizeof(T));
  const size_t smem = 4ull * C * D * sizeof(T);
  const bool pad = Dt != D;
  auto kernel = C < S ? (pad ? paged_attention_kernel<T, D, RPW, true, true>
                             : paged_attention_kernel<T, D, RPW, true, false>)
                      : (pad ? paged_attention_kernel<T, D, RPW, false, true>
                             : paged_attention_kernel<T, D, RPW, false, false>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, q_start, out, T_, H, KV, Dt, S, P,
      C, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Row-tile past D 256: the head dim a runtime value

// The row-tile kernel's loop (chunks of C slots, double buffered, 8-key
// groups from each multiple of 8 of a page, the same masks, roundings
// and online softmax) for any head dim past kRowOnlyPast. A warp's
// kWideRpw rows keep q and their f32 accumulator in shared memory after
// the K/V chunks (so one kernel serves every D); lane l owns columns 32c
// + l of both, so no lane reads another's and a warp reads 32
// consecutive elements of a K or V row at a time. A score is the
// lane's f32 sum over its D/32 columns, in order, finished with the
// template kernel's shuffle tree. PAD as the template kernel's.
template <typename T, bool PAD>
__global__ void __launch_bounds__(kThreads)
paged_attention_wide_kernel(const T* __restrict__ q,
                            const T* __restrict__ kp,
                            const T* __restrict__ vp,
                            const int* __restrict__ table,
                            const int* __restrict__ q_start,
                            float* __restrict__ out, int T_, int H, int KV,
                            int D, int dt_arg, int S, int P, int C,
                            float scale) {
  const int Dt = PAD ? dt_arg : D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);   // [2][K|V][C][D]
  float* const q_all =                             // [kWideRows][D]
      reinterpret_cast<float*>(smem_raw + 4ull * C * D * sizeof(T));
  float* const acc_all = q_all + kWideRows * D;    // [kWideRows][D]

  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int G = H / KV;
  const int rows_total = T_ * G;
  const int row0 = blockIdx.y * kWideRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nsl = D / 32;                          // 32-column slices
  const int qs = q_start[b];
  const int q_last = qs + (min(row0 + kWideRows, rows_total) - 1) / G;
  // the chunks whose first key lies at or before q_last, as the template
  // kernel counts them
  const int cpp = (S + C - 1) / C;
  const int last_page = min(P - 1, q_last / S);
  const int n_chunks =
      P > 0 ? last_page * cpp + min(cpp, (q_last - last_page * S) / C + 1)
            : 0;

  float m[kWideRpw], l[kWideRpw];
  int qpos[kWideRpw];
  int64_t obase[kWideRpw];
  bool live[kWideRpw];
#pragma unroll
  for (int i = 0; i < kWideRpw; ++i) {
    const int r = row0 + warp * kWideRpw + i;
    live[i] = r < rows_total;
    const int t = r / G, head = h * G + r % G;
    qpos[i] = qs + t;
    // q, the pools and out have rows of Dt; columns past Dt are zeros
    obase[i] = ((static_cast<int64_t>(b) * T_ + t) * H + head) * Dt + lane;
    m[i] = -INFINITY;
    l[i] = 0.f;
    float* const qr = q_all + (warp * kWideRpw + i) * D + lane;
    float* const ar = acc_all + (warp * kWideRpw + i) * D + lane;
    for (int c = 0; c < nsl; ++c) {
      qr[32 * c] = live[i] && (!PAD || 32 * c + lane < Dt)
                       ? to_f32(q[obase[i] + 32 * c]) : 0.f;
      ar[32 * c] = 0.f;
    }
  }

  const int* row_table = table + static_cast<int64_t>(b) * P;
  auto load = [&](int u, int j, int s0) {
    T* const dst = buf + static_cast<size_t>(u & 1) * 2 * C * D;
    load_slots<T, PAD>(dst, dst + static_cast<size_t>(C) * D, kp, vp,
                       row_table[j], s0, min(C, S - s0), h, S, KV, D, Dt);
  };
  if (n_chunks > 0) load(0, 0, 0);
  cp_async_commit();
  int j = 0, slot0 = 0;                 // chunk u: slots [slot0, + C) of j
  for (int u = 0; u < n_chunks; ++u) {
    const T* const ks = buf + static_cast<size_t>(u & 1) * 2 * C * D;
    const T* const vs = ks + static_cast<size_t>(C) * D;
    const bool wrap = slot0 + C >= S;   // the next chunk opens a page
    const int j_next = wrap ? j + 1 : j, s_next = wrap ? 0 : slot0 + C;
    if (u + 1 < n_chunks) load(u + 1, j_next, s_next);
    cp_async_commit();
    cp_async_wait_prev();               // chunk u has landed
    __syncthreads();
    const int n = min(C, S - slot0), key0 = j * S + slot0;
#pragma unroll
    for (int i = 0; i < kWideRpw; ++i) {
      if (!live[i]) continue;           // warp-uniform
      const float* const qr = q_all + (warp * kWideRpw + i) * D + lane;
      float* const ar = acc_all + (warp * kWideRpw + i) * D + lane;
      for (int c0 = 0; c0 < n; c0 += kKeyChunk) {
        const int nk = min(kKeyChunk, n - c0);
        const T* const kr = ks + static_cast<size_t>(c0) * D + lane;
        const T* const vr = vs + static_cast<size_t>(c0) * D + lane;
        float s[kKeyChunk];
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) s[kk] = 0.f;
        for (int c = 0; c < nsl; ++c) {
          const float qv = qr[32 * c];
#pragma unroll
          for (int kk = 0; kk < kKeyChunk; ++kk)
            if (kk < nk) s[kk] += qv * to_f32(kr[kk * D + 32 * c]);
        }
        float m_chunk = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            s[kk] += __shfl_xor_sync(0xffffffffu, s[kk], o);
          s[kk] = kk >= nk                     ? -INFINITY   // no key
                  : key0 + c0 + kk > qpos[i]   ? kMask
                                               : s[kk] * scale;
          m_chunk = fmaxf(m_chunk, s[kk]);
        }
        const float m_new = fmaxf(m[i], m_chunk);
        const float corr = expf(m[i] - m_new);
        float psum = 0.f, pr[kKeyChunk];
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) {
          const float p = expf(s[kk] - m_new);
          psum += p;
          pr[kk] = round_as(p, T{});
        }
        for (int c = 0; c < nsl; ++c) {
          float a = ar[32 * c] * corr;
#pragma unroll
          for (int kk = 0; kk < kKeyChunk; ++kk)
            if (kk < nk) a += pr[kk] * to_f32(vr[kk * D + 32 * c]);
          ar[32 * c] = a;
        }
        l[i] = l[i] * corr + psum;
        m[i] = m_new;
      }
    }
    __syncthreads();                    // buffer u & 1 is refilled next
    j = j_next;
    slot0 = s_next;
  }

#pragma unroll
  for (int i = 0; i < kWideRpw; ++i) {
    if (!live[i]) continue;
    const float* const ar = acc_all + (warp * kWideRpw + i) * D + lane;
    for (int c = 0; c < nsl; ++c)
      if (!PAD || 32 * c + lane < Dt)
        out[obase[i] + 32 * c] = ar[32 * c] / l[i];
  }
}

template <typename T>
int launch_wide(const void* q, const void* kp, const void* vp,
                const int* table, const int* q_start, float* out, int B,
                int T_, int H, int KV, int D, int Dt, int S, int P,
                float scale, cudaStream_t stream) {
  if (D % 64 != 0 || D > wide_max_d(sizeof(T))) return -1;
  const int rows_total = T_ * (H / KV);
  const dim3 grid(B * KV, (rows_total + kWideRows - 1) / kWideRows);
  const int C = row_chunk_slots(D, S, sizeof(T));
  const size_t smem = 4ull * C * D * sizeof(T) + row_fixed_bytes(D);
  auto kernel = Dt != D ? paged_attention_wide_kernel<T, true>
                        : paged_attention_wide_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, q_start, out, T_, H, KV, D, Dt, S, P,
      C, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Row-tile past wide_max_d: the output's columns sliced

// The wide kernel's arithmetic, in its order, for head dims past its cap
// (header). A CTA owns kWideRows query rows and the output columns
// [kSliceCols·z, + kSliceCols) (blockIdx.z = z, the last slice
// narrower); its f32 accumulator holds only those. Step t of its loop is
// (8-key group u = t / np, piece p = t % np) of the np column pieces of
// kSliceCols: the q rows and the group's K rows of the piece are staged
// (double-buffered with cp.async) and lane l adds the products of its
// columns 32c + l to its partial scores, so every lane sums its columns
// in the wide kernel's order and every slice forms the same scores, m
// and l; a group's first step also stages its V rows of the CTA's slice
// (double-buffered by group), which P·V takes at the group's last step.
// Groups are those of the wide kernel: 8 slots from each multiple of 8
// of each page, those whose first key lies past the CTA's last query
// never loaded. PAD as the template kernel's.
template <typename T, bool PAD>
__global__ void __launch_bounds__(kThreads)
paged_attention_sliced_kernel(const T* __restrict__ q,
                              const T* __restrict__ kp,
                              const T* __restrict__ vp,
                              const int* __restrict__ table,
                              const int* __restrict__ q_start,
                              float* __restrict__ out, int T_, int H, int KV,
                              int D, int dt_arg, int S, int P,
                              float scale) {
  const int Dt = PAD ? dt_arg : D;
  constexpr int kVec = 16 / sizeof(T);             // elements a copy
  constexpr int kStage = (kWideRows + kKeyChunk) * kSliceCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [2][q rows|K rows][piece]
  T* const vbuf = ring + 2 * kStage;               // [2][kKeyChunk][slice]
  float* const acc_all =                           // [kWideRows][slice]
      reinterpret_cast<float*>(vbuf + 2 * kKeyChunk * kSliceCols);

  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int G = H / KV;
  const int rows_total = T_ * G;
  const int row0 = blockIdx.y * kWideRows;
  const int col0 = blockIdx.z * kSliceCols, width = min(kSliceCols, D - col0);
  const int np = (D + kSliceCols - 1) / kSliceCols;   // pieces of a score
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qs = q_start[b];
  const int q_last = qs + (min(row0 + kWideRows, rows_total) - 1) / G;
  // the row's 8-key groups whose first key lies at or before q_last
  const int gpp = (S + kKeyChunk - 1) / kKeyChunk;
  const int last_page = min(P - 1, q_last / S);
  const int n_groups =
      P > 0 ? last_page * gpp +
                  min(gpp, (q_last - last_page * S) / kKeyChunk + 1)
            : 0;
  const int steps = n_groups * np;

  float m[kWideRpw], l[kWideRpw];
  int qpos[kWideRpw];
  int64_t obase[kWideRpw];
  bool live[kWideRpw];
#pragma unroll
  for (int i = 0; i < kWideRpw; ++i) {
    const int r = row0 + warp * kWideRpw + i;
    live[i] = r < rows_total;
    const int t = r / G, head = h * G + r % G;
    qpos[i] = qs + t;
    obase[i] = ((static_cast<int64_t>(b) * T_ + t) * H + head) * Dt;
    m[i] = -INFINITY;
    l[i] = 0.f;
    float* const ar = acc_all + (warp * kWideRpw + i) * kSliceCols + lane;
    for (int c = 0; c < width / 32; ++c) ar[32 * c] = 0.f;
  }

  const int* row_table = table + static_cast<int64_t>(b) * P;
  // q, the pools and out have rows of Dt; staged columns past Dt are
  // zeros. Rows of Dt·elt bytes a multiple of 16 go in 16-byte cp.async
  // copies, others element by element (plain loads and stores)
  const bool vec = Dt % kVec == 0;
  const int step = vec ? kVec : 1;                 // elements a copy
  // `w` elements from column d0 of a row (`src`, nullptr: a q row past
  // the CTA's rows, never read, not loaded) into `dst`
  auto stage = [&](T* dst, const T* src, int d0, int w) {
    if (src == nullptr) return;
    if (d0 + w >= Dt) {
      if (vec)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      else
        *dst = T{};
    } else if (vec) {
      cp_async16(dst, src + d0 + w);
    } else {
      *dst = src[d0 + w];
    }
  };
  // step t: the piece's columns of the CTA's live q rows and of the
  // group's K rows; at the group's first piece its V rows of the slice
  auto load = [&](int t) {
    const int u = t / np, p = t % np, j = u / gpp;
    const int slot0 = (u % gpp) * kKeyChunk, n = min(kKeyChunk, S - slot0);
    const int d0 = p * kSliceCols, pw = min(kSliceCols, D - d0);
    T* const st = ring + (t & 1) * kStage;
    const int64_t page = row_table[j];
    const int64_t kbase = ((page * S + slot0) * KV + h) * Dt;
    if (Dt == D) {      // no padding: 16-byte copies (header: kept)
      const int per = pw / kVec;
      for (int c = threadIdx.x; c < (kWideRows + n) * per; c += kThreads) {
        const int r = c / per, w = (c % per) * kVec;
        if (r < kWideRows) {
          const int qr = row0 + r;
          if (qr < rows_total) {
            const int tq = qr / G, head = h * G + qr % G;
            cp_async16(st + r * kSliceCols + w,
                       q + ((static_cast<int64_t>(b) * T_ + tq) * H + head)
                           * D + d0 + w);
          }
        } else {
          const int s = r - kWideRows;
          cp_async16(st + r * kSliceCols + w,
                     kp + kbase + static_cast<int64_t>(s) * KV * D + d0 + w);
        }
      }
      if (p == 0) {
        T* const vs = vbuf + (u & 1) * kKeyChunk * kSliceCols;
        const int wper = width / kVec;
        for (int c = threadIdx.x; c < n * wper; c += kThreads) {
          const int s = c / wper, w = (c % wper) * kVec;
          cp_async16(vs + s * kSliceCols + w,
                     vp + kbase + static_cast<int64_t>(s) * KV * D + col0 + w);
        }
      }
      return;
    }
    const int per = pw / step;                     // copies a row
    for (int c = threadIdx.x; c < (kWideRows + n) * per; c += kThreads) {
      const int r = c / per, w = (c % per) * step;
      const T* src;
      if (r < kWideRows) {
        const int qr = row0 + r;
        const int tq = qr / G, head = h * G + qr % G;
        src = qr < rows_total
                  ? q + ((static_cast<int64_t>(b) * T_ + tq) * H + head) * Dt
                  : nullptr;
      } else {
        src = kp + kbase + static_cast<int64_t>(r - kWideRows) * KV * Dt;
      }
      stage(st + r * kSliceCols + w, src, d0, w);
    }
    if (p == 0) {
      T* const vs = vbuf + (u & 1) * kKeyChunk * kSliceCols;
      const int wper = width / step;
      for (int c = threadIdx.x; c < n * wper; c += kThreads) {
        const int s = c / wper, w = (c % wper) * step;
        stage(vs + s * kSliceCols + w,
              vp + kbase + static_cast<int64_t>(s) * KV * Dt, col0, w);
      }
    }
  };

  float s[kWideRpw][kKeyChunk];
  if (steps > 0) load(0);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) load(t + 1);
    cp_async_commit();
    cp_async_wait_prev();               // step t (and its V rows) landed
    __syncthreads();
    const int u = t / np, p = t % np, j = u / gpp;
    const int slot0 = (u % gpp) * kKeyChunk, nk = min(kKeyChunk, S - slot0);
    const int pw = min(kSliceCols, D - p * kSliceCols);
    const T* const st = ring + (t & 1) * kStage;
    const T* const kr = st + kWideRows * kSliceCols + lane;
#pragma unroll
    for (int i = 0; i < kWideRpw; ++i) {
      if (!live[i]) continue;           // warp-uniform
      if (p == 0) {
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk) s[i][kk] = 0.f;
      }
      const T* const qr = st + (warp * kWideRpw + i) * kSliceCols + lane;
      for (int c = 0; c < pw / 32; ++c) {
        const float qv = to_f32(qr[32 * c]);
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk)
          if (kk < nk) s[i][kk] += qv * to_f32(kr[kk * kSliceCols + 32 * c]);
      }
      if (p < np - 1) continue;
      // the group's scores are whole: the wide kernel's softmax and P·V
      const int key0 = j * S + slot0;
      float m_chunk = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeyChunk; ++kk) {
        float x = s[i][kk];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        x = kk >= nk                   ? -INFINITY   // no key
            : key0 + kk > qpos[i]      ? kMask
                                       : x * scale;
        s[i][kk] = x;
        m_chunk = fmaxf(m_chunk, x);
      }
      const float m_new = fmaxf(m[i], m_chunk);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f, pr[kKeyChunk];
#pragma unroll
      for (int kk = 0; kk < kKeyChunk; ++kk) {
        const float pv = expf(s[i][kk] - m_new);
        psum += pv;
        pr[kk] = round_as(pv, T{});
      }
      const T* const vr = vbuf + (u & 1) * kKeyChunk * kSliceCols + lane;
      float* const ar = acc_all + (warp * kWideRpw + i) * kSliceCols + lane;
      for (int c = 0; c < width / 32; ++c) {
        float a = ar[32 * c] * corr;
#pragma unroll
        for (int kk = 0; kk < kKeyChunk; ++kk)
          if (kk < nk) a += pr[kk] * to_f32(vr[kk * kSliceCols + 32 * c]);
        ar[32 * c] = a;
      }
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
    }
    __syncthreads();                    // stage t & 1 is refilled next
  }

#pragma unroll
  for (int i = 0; i < kWideRpw; ++i) {
    if (!live[i]) continue;
    const float* const ar =
        acc_all + (warp * kWideRpw + i) * kSliceCols + lane;
    for (int c = 0; c < width / 32; ++c)
      if (!PAD || col0 + lane + 32 * c < Dt)
        out[obase[i] + col0 + lane + 32 * c] = ar[32 * c] / l[i];
  }
}

template <typename T>
int launch_sliced(const void* q, const void* kp, const void* vp,
                  const int* table, const int* q_start, float* out, int B,
                  int T_, int H, int KV, int D, int Dt, int S, int P,
                  float scale, cudaStream_t stream) {
  if (D % 64 != 0 || D <= wide_max_d(sizeof(T))) return -1;
  const int rows_total = T_ * (H / KV);
  const dim3 grid(B * KV, (rows_total + kWideRows - 1) / kWideRows,
                  (D + kSliceCols - 1) / kSliceCols);
  const size_t smem = sliced_smem_bytes(sizeof(T));
  auto kernel = Dt != D ? paged_attention_sliced_kernel<T, true>
                        : paged_attention_sliced_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, q_start, out, T_, H, KV, D, Dt, S, P,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Split-KV decode

constexpr int kSplitRows = 16;     // T·G query rows a split CTA holds

struct Call {                      // one call's operands and geometry
  const void *q, *kp, *vp;
  const int *table, *q_start;
  float *out, *ws;
  int* counters;
  // D: the head dim the call's kernel is built for (built_dim), which
  // picks the instantiation and lays out shared memory and the split
  // workspace; Dt: the pools', q's and out's, for every stride, extent
  // and store. NP: pages in each pool
  int B, T, H, KV, D, Dt, S, P, NP, pps;
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one 16-byte vector of shared memory, widened to f32
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {      // element 2i is the low half of word i
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory of a split CTA, in bytes (rows = the kernel's ROWS, the
// query rows past T·G zero): [stage | q (f32) | q as copied (bf16 pools
// only) | scores | key offsets | m, l, corr, last flag | page ids]. The
// stage region (nst stages of K and V rows, kc keys each, rows of D·elt
// + 16 bytes) is reused at the end for the partial accumulators of
// `red_groups` thread groups; the key offsets (the pool element of each
// staged row) are kept per stage.
struct SplitSmem {
  size_t q, qraw, sc, koff, stats, pages, total;
};
__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline SplitSmem split_smem(int rows, int d, int elt,
                                                int kc, int nst,
                                                int red_groups, int pps) {
  const size_t stage = static_cast<size_t>(nst) * 2 * kc * (d * elt + 16);
  const size_t red = static_cast<size_t>(red_groups) * rows * d * 4;
  SplitSmem m;
  m.q = stage > red ? stage : red;
  m.qraw = m.q + static_cast<size_t>(rows) * d * 4;
  m.sc = m.qraw + (elt == 4 ? 0 : static_cast<size_t>(rows) * d * elt);
  m.koff = up16(m.sc + static_cast<size_t>(rows) * kc * 4);
  m.stats = m.koff + static_cast<size_t>(nst) * kc * 8;
  m.pages = up16(m.stats + (3ull * rows + 1) * 4);
  m.total = m.pages + static_cast<size_t>(pps) * 4;
  return m;
}

template <typename T, int D>
struct SplitShape {
  static constexpr int kVec = 16 / sizeof(T);     // elements per vector
  static constexpr int kVpr = D / kVec;           // vectors per K/V row
  static constexpr int kRowB = D * sizeof(T) + 16;  // padded smem row
  // P·V: a thread owns one vector slice of D; kKeyGroups threads share it
  // (at D 192, 24 or 48 vectors a row: 5 or 2 groups, and the last 8 or
  // 32 threads take no part in P·V)
  static constexpr int kKeyGroups = kThreads / kVpr;
  // where the slices of a row divide a warp, the lanes that share a slice
  // are summed by shuffles and one partial per warp is kept; otherwise
  // each key group keeps its own
  static constexpr bool kShuffle = kVpr < 32 && 32 % kVpr == 0;
  static constexpr int kRedSpan = kShuffle ? 32 : kVpr;
  static constexpr int kRedGroups = kThreads / kRedSpan;
};

// One CTA per (row b, kv head, split of pps pages). Writes the split's f32
// partial (m, l, unnormalised acc) per query row; the last live split CTA
// of a (row, kv head) to finish (counted in `counters`, which it resets to
// 0 for the next call) merges the row's live partials into `out`. PAD:
// the pools' head dim dt_arg lies below D, as the row-tile kernel's.
template <typename T, int D, int ROWS, bool PAD>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int* __restrict__ table,
                          const int* __restrict__ q_start,
                          float* __restrict__ out, float* part_acc,
                          float* part_ml, int* counters, int T_, int H,
                          int KV, int dt_arg, int S, int P, int pps, int kc,
                          int nst, float scale) {
  const int Dt = PAD ? dt_arg : D;
  using Sh = SplitShape<T, D>;
  constexpr int kVec = Sh::kVec, kVpr = Sh::kVpr, kRowB = Sh::kRowB;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int G = H / KV, R = T_ * G;
  const int bkv = blockIdx.x, b = bkv / KV, h = bkv % KV;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const SplitSmem lay =
      split_smem(ROWS, D, sizeof(T), kc, nst, Sh::kRedGroups, pps);
  unsigned char* const stage = smem_raw;
  float* const q_s = reinterpret_cast<float*>(smem_raw + lay.q);
  // q as copied: f32 pools copy straight into q_s
  T* const q_raw = reinterpret_cast<T*>(smem_raw + (sizeof(T) == 4 ? lay.q
                                                                   : lay.qraw));
  float* const sc = reinterpret_cast<float*>(smem_raw + lay.sc);
  int64_t* const koff = reinterpret_cast<int64_t*>(smem_raw + lay.koff);
  float* const st_m = reinterpret_cast<float*>(smem_raw + lay.stats);
  float* const st_l = st_m + ROWS;
  float* const st_c = st_l + ROWS;
  int* const last_flag = reinterpret_cast<int*>(st_c + ROWS);
  int* const pages = reinterpret_cast<int*>(smem_raw + lay.pages);

  // q_start, the split's page ids and the q rows (cp.async, one 16-byte
  // vector a thread): loads issued together, before the row's length is
  // known; the rows past R are zeros, so the row loops need no bound.
  // q, the pools and out have rows of Dt (a multiple of kVec: route_of);
  // the columns past it are zeros in q and in every staged K/V row
  const int qs = q_start[b];
  const int p0 = split * pps, n_pages = min(pps, P - p0);
  const int valid = Dt / kVec;                  // vectors of a pool row
  for (int i = tid; i < n_pages; i += kThreads)
    pages[i] = table[static_cast<int64_t>(b) * P + p0 + i];
  for (int i = tid; i < ROWS * kVpr; i += kThreads) {
    const int r = i / kVpr, v = i % kVpr;
    T* const dst = q_raw + r * D + v * kVec;
    if (r < R && v < valid) {
      const int t = r / G, head = h * G + r % G;
      cp_async16(dst, q + ((static_cast<int64_t>(b) * T_ + t) * H + head) *
                              Dt + v * kVec);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_async_commit();
  const int last = qs + T_ - 1;                 // last key any row attends
  const int k_begin = p0 * S;
  if (k_begin > last) {                         // split wholly past the row
    cp_async_wait_all();
    return;
  }
  const int k_end = min(min(k_begin + pps * S, last + 1), P * S);
  const int n_chunks = (k_end - k_begin + kc - 1) / kc;
  if (tid < ROWS) {
    st_m[tid] = -INFINITY;
    st_l[tid] = 0.f;
    st_c[tid] = 0.f;
  }
  __syncthreads();                              // pages

  // issue cp.async copies of the K and V rows of chunk c into stage st
  // (stage st's offsets were last read before the previous chunk's syncs)
  auto load_chunk = [&](int c, int st) {
    const int k0 = c * kc;                      // relative to k_begin
    const int n = min(kc, k_end - k_begin - k0);
    int64_t* const off = koff + static_cast<size_t>(st) * kc;
    for (int k = tid; k < n; k += kThreads) {
      const int rel = k0 + k;
      off[k] = ((static_cast<int64_t>(pages[rel / S]) * S + rel % S) * KV +
                h) * Dt;
    }
    __syncthreads();
    unsigned char* const ks = stage + static_cast<size_t>(st) * 2 * kc * kRowB;
    unsigned char* const vs = ks + static_cast<size_t>(kc) * kRowB;
    for (int i = tid; i < n * kVpr; i += kThreads) {
      const int k = i / kVpr, v = i % kVpr;
      if (!PAD || v < valid) {
        const int64_t g = off[k] + v * kVec;
        cp_async16(ks + k * kRowB + v * 16, kp + g);
        cp_async16(vs + k * kRowB + v * 16, vp + g);
      } else {
        *reinterpret_cast<uint4*>(ks + k * kRowB + v * 16) =
            make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + k * kRowB + v * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load_chunk(0, 0);
  cp_async_commit();

  float acc[ROWS][kVec];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[r][i] = 0.f;
  const int slice = tid % kVpr, kg = tid / kVpr;
  // threads past the last whole key group start past every key
  const int kfirst = kg < Sh::kKeyGroups ? kg : kc;

  for (int c = 0; c < n_chunks; ++c) {
    // nst == 1 only when the whole split is one chunk
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) % nst);
    cp_async_commit();
    cp_async_wait_prev();                        // chunk c has landed
    __syncthreads();
    const int k0 = k_begin + c * kc;
    const int n = min(kc, k_end - k0);
    const unsigned char* const ks =
        stage + static_cast<size_t>(c % nst) * 2 * kc * kRowB;
    const unsigned char* const vs = ks + static_cast<size_t>(kc) * kRowB;

    if (sizeof(T) == 2 && c == 0) {     // q rows to f32, once
      for (int e = tid; e < ROWS * D; e += kThreads) q_s[e] = to_f32(q_raw[e]);
      __syncthreads();
    }

    // scores: two threads a key (lanes l and l + 16 of a warp take the
    // two halves of D, one shuffle joins them) and two keys a thread (64
    // apart), so each q vector read from shared memory feeds both keys;
    // every query row from one read of each K vector; rows past R score 0
    // and are never read as p
    for (int kb = 0; kb < n; kb += kThreads) {
      const int ka = kb + warp * 16 + lane % 16, kz = ka + kThreads / 2;
      const int half = lane / 16;
      const bool oka = ka < n, okz = kz < n;
      float sa[ROWS], sz[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sa[r] = sz[r] = 0.f;
      const int hoff = half * (kVpr / 2) * 16;
      const unsigned char* const kra = ks + (oka ? ka : 0) * kRowB + hoff;
      const unsigned char* const krz = ks + (okz ? kz : 0) * kRowB + hoff;
      const float* const qh = q_s + half * (D / 2);
      // unrolled whole where registers allow, so loads run ahead of FMAs
      constexpr int kScoreUnroll = ROWS <= 4 ? kVpr / 2 : 2;
#pragma unroll (kScoreUnroll)
      for (int v = 0; v < kVpr / 2; ++v) {
        float fa[kVec], fz[kVec];
        load_vec(reinterpret_cast<const T*>(kra + v * 16), fa);
        load_vec(reinterpret_cast<const T*>(krz + v * 16), fz);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float* const qr = qh + r * D + v * kVec;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            sa[r] = fmaf(qv.x, fa[e], sa[r]);
            sz[r] = fmaf(qv.x, fz[e], sz[r]);
            sa[r] = fmaf(qv.y, fa[e + 1], sa[r]);
            sz[r] = fmaf(qv.y, fz[e + 1], sz[r]);
            sa[r] = fmaf(qv.z, fa[e + 2], sa[r]);
            sz[r] = fmaf(qv.z, fz[e + 2], sz[r]);
            sa[r] = fmaf(qv.w, fa[e + 3], sa[r]);
            sz[r] = fmaf(qv.w, fz[e + 3], sz[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float a = sa[r] + __shfl_xor_sync(0xffffffffu, sa[r], 16);
        const float z = sz[r] + __shfl_xor_sync(0xffffffffu, sz[r], 16);
        if (half == 0) {
          const int last_r = qs + r / G;
          if (oka) sc[r * kc + ka] = k0 + ka > last_r ? kMask : a * scale;
          if (okz) sc[r * kc + kz] = k0 + kz > last_r ? kMask : z * scale;
        }
      }
    }
    __syncthreads();

    // online softmax, once a chunk: one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float* const row = sc + r * kc;
      float cm = -INFINITY;
      for (int k = lane; k < n; k += 32) cm = fmaxf(cm, row[k]);
      cm = warp_max(cm);
      const float m_old = st_m[r];
      const float m_new = fmaxf(m_old, cm);
      float ps = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float p = expf(row[k] - m_new);
        ps += p;
        row[k] = round_as(p, T{});     // P·V takes p in the pool dtype
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        st_c[r] = corr;
        st_l[r] = st_l[r] * corr + ps;
        st_m[r] = m_new;
      }
    }
    __syncthreads();

    // P·V: one V vector read feeds every query row
    // (rows past R accumulate scores, not p; they are never written)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float corr = st_c[r];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[r][i] *= corr;
    }
#pragma unroll 4
    for (int k = kfirst; k < n; k += Sh::kKeyGroups) {
      float vf[kVec];
      load_vec(reinterpret_cast<const T*>(vs + k * kRowB + slice * 16), vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = sc[r * kc + k];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[r][i] = fmaf(p, vf[i], acc[r][i]);
      }
    }
    __syncthreads();                   // the stage and scores are refilled
  }

  // sum the slices' partials: lanes that share a slice, then groups
  if constexpr (Sh::kShuffle) {
#pragma unroll
    for (int o = kVpr; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
  }
  float* const red = reinterpret_cast<float*>(stage);  // no copy in flight
  if (tid < Sh::kRedGroups * Sh::kRedSpan && tid % Sh::kRedSpan < kVpr) {
    const int grp = tid / Sh::kRedSpan;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= R) break;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        red[(grp * R + r) * D + slice * kVec + i] = acc[r][i];
    }
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(bkv) * n_split;
  const int64_t pbase = (base + split) * R;
  for (int e = tid; e < R * D; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < Sh::kRedGroups; ++g) a += red[g * R * D + e];
    part_acc[pbase * D + e] = a;
  }
  if (tid < R) {
    part_ml[(pbase + tid) * 2] = st_m[tid];
    part_ml[(pbase + tid) * 2 + 1] = st_l[tid];
  }

  // the last live split of (b, h) to get here merges: thread 0's
  // acquire-release add orders every thread's partial stores (before the
  // barrier) ahead of it, and the other CTAs' stores ahead of the loads
  // below (after the barrier), as CUTLASS's barriers do
  const int n_live = min(n_split, last / (pps * S) + 1);
  __syncthreads();
  if (tid == 0) {
    int done;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(done) : "l"(counters + bkv) : "memory");
    *last_flag = done == n_live - 1;
    if (*last_flag) counters[bkv] = 0;   // every live split has counted
  }
  __syncthreads();
  if (!*last_flag) return;

  // o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s: one warp per
  // query row, lanes over splits for M and the sum, then over D; the
  // partials are read from L2 (__ldcg), where the other CTAs wrote them,
  // in batches of splits whose loads are all issued before they are used
  // (the first batch together with (m, l))
  constexpr int kDpl = D / 32;
  constexpr int kBatch = kDpl <= 4 ? 16 : 8;
  for (int r = warp; r < R; r += kWarps) {
    const float* const ml = part_ml + (base * R + r) * 2;   // split s: s·2R
    auto load_batch = [&](int j0, float (&av)[kBatch][kDpl]) {
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj < n_live ? j0 + jj : 0;   // past: weight 0
        const float* const a = part_acc + ((base + j) * R + r) * D;
#pragma unroll
        for (int i = 0; i < kDpl; ++i) av[jj][i] = __ldcg(a + lane + 32 * i);
      }
    };
    float av[kBatch][kDpl];
    load_batch(0, av);
    // lane s holds (m, l) of split s; splits past 32 are read again below
    const float m_lane = lane < n_live ? __ldcg(ml + lane * 2 * R) : -INFINITY;
    const float l_lane = lane < n_live ? __ldcg(ml + lane * 2 * R + 1) : 0.f;
    float m_all = m_lane;
    for (int s = lane + 32; s < n_live; s += 32)
      m_all = fmaxf(m_all, __ldcg(ml + s * 2 * R));
    m_all = warp_max(m_all);
    float l_all = lane < n_live ? expf(m_lane - m_all) * l_lane : 0.f;
    for (int s = lane + 32; s < n_live; s += 32)
      l_all += expf(__ldcg(ml + s * 2 * R) - m_all) * __ldcg(ml + s * 2 * R + 1);
    l_all = warp_sum(l_all);
    float o[kDpl];
#pragma unroll
    for (int i = 0; i < kDpl; ++i) o[i] = 0.f;
    for (int j0 = 0; j0 < n_live; j0 += kBatch) {
      if (j0 > 0) load_batch(j0, av);
      // lane jj < kBatch: the weight of split j0 + jj, its max from the
      // lane that holds it (the first 32 splits) or from L2
      const float m_held = __shfl_sync(0xffffffffu, m_lane, (j0 + lane) % 32);
      const bool live = j0 + lane < n_live;
      const float m_j = j0 < 32 ? m_held
                        : live  ? __ldcg(ml + (j0 + lane) * 2 * R)
                                : -INFINITY;
      const float w_lane = live ? expf(m_j - m_all) : 0.f;
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const float w = __shfl_sync(0xffffffffu, w_lane, jj);
#pragma unroll
        for (int i = 0; i < kDpl; ++i) o[i] = fmaf(w, av[jj][i], o[i]);
      }
    }
    const int t = r / G, head = h * G + r % G;
    float* const dst =
        out + ((static_cast<int64_t>(b) * T_ + t) * H + head) * Dt;
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      if (!PAD || lane + 32 * i < Dt) dst[lane + 32 * i] = o[i] / l_all;
  }
}

template <typename T, int D, int ROWS>
int launch_split(const Call& a) {
  using Sh = SplitShape<T, D>;
  const int R = a.T * (a.H / a.KV);
  const int n_split = (a.P + a.pps - 1) / a.pps;
  const int split_keys = a.pps * a.S;
  auto bytes = [&](int kc, int nst) {
    return split_smem(ROWS, D, sizeof(T), kc, nst, Sh::kRedGroups, a.pps)
        .total;
  };
  // one stage holding the whole split where it fits, else two stages of
  // the most keys that fit (at most half the split)
  int nst = 1, kc = split_keys;
  if (bytes(kc, 1) > kSmemMax) {
    nst = 2;
    kc = (split_keys + 1) / 2;
    while (kc > 1 && bytes(kc, 2) > kSmemMax) kc = kc * 7 / 8;
  }
  const size_t smem = bytes(kc, nst);
  if (smem > kSmemMax) return -4;      // pps too large for the page ids
  float* const part_acc = a.ws;
  float* const part_ml =
      a.ws + static_cast<size_t>(a.B) * a.KV * n_split * R * D;
  auto split = a.Dt != D ? paged_decode_split_kernel<T, D, ROWS, true>
                         : paged_decode_split_kernel<T, D, ROWS, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split<<<dim3(a.B * a.KV, n_split), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.table, a.q_start, a.out, part_acc,
      part_ml, a.counters, a.T, a.H, a.KV, a.Dt, a.S, a.P, a.pps, kc, nst,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Tensor-core prefill (bf16)

namespace tc {

using namespace hopper;

constexpr int kWgRows = 64;        // folded query rows a warpgroup
constexpr int kTcWarpgroups = 1;   // consumer warpgroups a CTA
constexpr int kConsumers = 128 * kTcWarpgroups;    // their threads
constexpr int kTcThreads = kConsumers + 32;        // + the producer warp
constexpr int kTcRows = kWgRows * kTcWarpgroups;   // folded rows a CTA
constexpr int kTcKeys = 64;        // keys a tile
constexpr int kTcMaxPages = 4096;  // block-table entries a CTA stages
constexpr int kSlotPad = 8;        // a page's slots padded to a multiple

// named barrier 1 over the consumer warpgroups' threads (the producer
// warp is elsewhere)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 64-wide column chunks of a D-wide tile (D 32: one, zero-filled past D)
__host__ __device__ constexpr int chunks(int D) { return (D + 63) / 64; }
// gp: the group of G query heads padded to a power of two, which divides
// the kWgRows folded rows (G itself where 64 % G == 0)
__host__ __device__ inline int pad_group(int G) {
  int gp = 1;
  while (gp < G) gp <<= 1;
  return gp;
}
// F: folded rows a query column takes, gp up to kWgRows heads, else G
// itself (the flat fold, Q loaded by the consumers)
__host__ __device__ inline int fold_of(int G) {
  return G > kWgRows ? G : pad_group(G);
}
// S8: a page's slots padded to a multiple of kSlotPad (S where S % 8 == 0)
__host__ __device__ inline int pad_slots(int S) {
  return (S + kSlotPad - 1) / kSlotPad * kSlotPad;
}
// rows of a K/V box: the largest of 64, 32, 16, 8 that divides S8
__host__ __device__ inline int box_rows(int S8) {
  return S8 % 64 == 0 ? 64 : S8 % 32 == 0 ? 32 : S8 % 16 == 0 ? 16 : 8;
}

template <int D>
struct TcShape {
  static constexpr int kC = chunks(D);
  static constexpr int kStages = D > 128 ? 2 : 4;
  static constexpr int kQ = kTcRows * kC * kRowBytes;    // the Q tile
  static constexpr int kKV = kTcKeys * kC * kRowBytes;   // a K or V tile
  using L = Layout<kStages, kQ, 2 * kKV>;
  // the page ids follow the barriers (offsets from the 1024-aligned base)
  static constexpr int kPagesAt =
      (L::kBars + 8 * (2 * kStages + 1) + 15) / 16 * 16;
  static size_t smem(int P) {
    return 1024 + kPagesAt + static_cast<size_t>(P) * 4;
  }
};

// One 64-key tile of the online softmax, shared by both tensor-core
// prefill kernels: this thread's scores s (rows rl and rl + 8 of the
// tile, element i at padded key k0 + 8·(i/4) + i%2 + 2·(l%4)) become P
// in bf16 fragments pf at the running max m, the row sums lsum take the
// tile's part, and the N 64-column accumulator chunks are rescaled to
// the new max. Scaled to base 2 (exp(x) = 2^(x·log2 e)); only a tile
// that reaches past the warpgroup's first query position first_wg
// masks, in a loop of its own (a test inside one loop costs every tile
// the masking): keys past a row's query position qpos, and so the
// unloaded slots past the CTA's last one (klast, unpadded), score the
// finite -1e9, whose weight is 0 in either base
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&acc)[N][32], float (&s)[32], float (&m)[2], float (&lsum)[2],
    uint32_t (&pf)[kTcKeys / 16][4], int k0, int S, int S8,
    const int (&qpos)[2], int klast, int first_wg, float scale2, int l) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (S8 != S) {
    // padded pages: every tile holds padded slots (s >= S), which are
    // no keys and score -inf, so each weighs exactly 0. Elements 4j..4j
    // + 3 sit in the 8-slot group of padded key k0 + 8j, at slot sb of
    // page pg (stepped along, one division a tile); element i at slot
    // sb + i%2 + 2·(l%4), logical key pg·S + that slot, masked (-1e9)
    // past the row's query position or the last key loaded. Where S8
    // == S this loop computes what the next one does (room >= 2), but
    // slower: with it for every page, pages of 16-256 slots took up to
    // 4.1 % more than a kernel without padding, with two loops up to
    // 2.7 % (PERF.md §6), so those keep their own loop
    const int o = 2 * (l % 4);
    const int lim[2] = {min(qpos[0], klast), min(qpos[1], klast)};
    int pg = k0 / S8, sb = k0 - pg * S8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = pg * S + sb + o, room = S - sb - o;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e / 2;
        s[i] = e % 2 >= room             ? -INFINITY
               : key + e % 2 > lim[r]    ? kMask
                                         : s[i] * scale2;
        mx[r] = fmaxf(mx[r], s[i]);
      }
      sb += 8;
      if (sb == S8) {
        sb = 0;
        ++pg;
      }
    }
  } else if (k0 + kTcKeys - 1 > first_wg) {
    // element i sits at key k0 + 8·(i/4) + i%2 + 2·(l%4)
    const int lim[2] = {min(qpos[0], klast) - k0 - 2 * (l % 4),
                        min(qpos[1], klast) - k0 - 2 * (l % 4)};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 8 * (i / 4) + i % 2 > lim[(i % 4) / 2] ? kMask
                                                    : s[i] * scale2;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= scale2;
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    lsum[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - m[(i % 4) / 2]);
    lsum[(i % 4) / 2] += s[i];           // this thread's part of the row
  }
  to_frags<kTcKeys / 16>(s, pf);        // p in bf16 at the running max
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i % 4) / 2];
}

// f32 rows straight from the accumulator's N 64-column chunks, which
// start at out's column col0: folded row R = r0 + rl + 8r is query
// column R / F, head h·G + R % F; the padded rows (a head past the
// group's G) and rows past T are never written, nor the columns past
// out's Dt (a multiple of 8)
template <int N>
__device__ __forceinline__ void store_rows(
    const float (&acc)[N][32], const float (&lsum)[2], float* out, int b,
    int h, int T_, int H, int G, int F, int Dt, int r0, int rl, int col0,
    int l) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(lsum[r]);
    const int fr = r0 + rl + 8 * r, t = fr / F;
    if (t >= T_ || fr % F >= G) continue;
    float* const row =
        out + ((static_cast<int64_t>(b) * T_ + t) * H + h * G + fr % F) * Dt +
        col0;
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col0 + 64 * c + 8 * j >= Dt) continue;    // zeros past Dt
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(row + 64 * c + acc_col(i, l)) =
            make_float2(acc[c][i] * inv, acc[c][i + 1] * inv);
      }
  }
}

// One CTA per (row b, kv head, kTcRows folded query rows); see the
// header.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
paged_prefill_tc_kernel(const __grid_constant__ CUtensorMap qm,
                        const __grid_constant__ CUtensorMap km,
                        const __grid_constant__ CUtensorMap vm,
                        const __nv_bfloat16* __restrict__ q,
                        const int* __restrict__ table,
                        const int* __restrict__ q_start,
                        float* __restrict__ out, int T_, int H, int KV,
                        int Dt, int S, int P, float scale) {
  using Sh = TcShape<D>;
  constexpr int kC = Sh::kC, kStages = Sh::kStages;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, g = tid / 128, w = (tid / 32) % 4;
  const int l = tid % 32;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV, G = H / KV;
  const int F = fold_of(G), S8 = pad_slots(S);
  const bool flat = G > kWgRows;         // Q loaded by the consumers
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // most keys first
  const int t0 = r0 / F;                 // first query column
  const int tn = min(T_ - t0, (r0 + kTcRows - 1) / F - t0 + 1);  // columns

  // the row's page ids and q_start, read together, once, before any load
  unsigned char* const base =
      smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) -
                  smem_u32(smem_raw));
  int* const pages = reinterpret_cast<int*>(base + Sh::kPagesAt);
  const int* const row_table = table + static_cast<int64_t>(b) * P;
  for (int j = tid; j < P; j += kTcThreads) pages[j] = row_table[j];
  const int qs = q_start[b];
  const Ring<kStages> ring =
      make_ring<kStages>(smem_raw, Sh::L::kBars, kConsumers / 32);

  const int first = qs + t0;             // the CTA's first query position
  // pages j with j·S <= the last query position hold every key read;
  // tiles walk padded keys, slot s of page j being padded key j·S8 + s
  const int n_pages = min(P, (first + tn - 1) / S + 1);
  const int kend = n_pages * S8;         // padded keys loaded
  const int nkt = (kend + kTcKeys - 1) / kTcKeys;
  const int br = box_rows(S8);
  const uint32_t qsm = ring.base, kv0 = ring.base + Sh::kQ;

  if (tid >= kConsumers) {
    // the producer warp: Q, then every key tile through the ring, each
    // stage refilled once the consumer warps have released it. A tile's
    // boxes are issued by the warp's lanes together (a TMA issue costs
    // some 100 cycles; the consumers never wait on one but the first
    // tile's). Slots of pages < n_pages come from the pools; the rest
    // are boxes at page -1, out of bounds, which TMA fills with zeros:
    // their scores are masked and their V rows must be finite (0 x NaN
    // is NaN), whatever a stage held before. A page's last box reaches
    // past slot S - 1 where S % 8 != 0: those rows are out of bounds
    // too, zeros as well. Q's box holds gp heads from h·G: past G it
    // reads the next group's heads, or zeros past H.
    if (l == 0 && !flat) {
      bar_expect(ring.once(), Sh::kQ);
#pragma unroll
      for (int c = 0; c < kC; ++c)
        tma_load(qsm + c * kTcRows * kRowBytes, &qm, ring.once(), c * 64,
                 h * G, t0, b);
    }
    for (int t = 0; t < nkt; ++t) {
      const int st = t % kStages, k0 = t * kTcKeys;
      if (t >= kStages) warp_wait(ring.empty(st), (t / kStages - 1) & 1);
      if (l == 0) bar_expect(ring.full(st), 2 * kC * kTcKeys * kRowBytes);
      __syncwarp();
      const uint32_t ks = kv0 + st * 2 * Sh::kKV, vs = ks + Sh::kKV;
      for (int e = l; e < 2 * kC * (kTcKeys / br); e += 32) {
        const int i = e / (2 * kC) * br, c = e / 2 % kC, k = k0 + i;
        const int page = k < kend ? pages[k / S8] : -1;
        const uint32_t at = c * kTcKeys * kRowBytes + i * kRowBytes;
        tma_load((e % 2 ? vs : ks) + at, e % 2 ? &vm : &km, ring.full(st),
                 c * 64, h, k % S8, page);
      }
    }
    return;
  }

  // this thread's accumulator rows: folded rows rl and rl + 8 of the
  // tile; its warpgroup's first row sits at query position first_wg
  const int rl = kWgRows * g + 16 * w + l / 4;
  const int qpos[2] = {qs + (r0 + rl) / F, qs + (r0 + rl + 8) / F};
  const int first_wg = qs + (r0 + kWgRows * g) / F;
  const int klast = n_pages * S - 1;     // the last key loaded, unpadded
  const float scale2 = scale * 1.4426950408889634f;   // log2 e
  float acc[kC][32], m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kC; ++c) zero(acc[c]);
  if (flat) {
    // Q of the flat fold: 16-byte chunk j of 64-column chunk c of folded
    // row r (query column R / G, head h·G + R % G) lands at chunk j ^ (r
    // % 8) of its row, as TMA's 128-byte swizzle puts it; zeros past T
    // and past q's Dt columns (a multiple of 8: route_of). A thread
    // issues all its kLoads loads before its first store,
    // so they are in flight together. Fenced for the async proxy, then
    // every consumer waits for every other's part before the first wgmma
    constexpr int kLoads = kTcRows * kC * 8 / kConsumers;   // 4·kC
    uint4 v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kConsumers;
      const int j = e % 8, c = e / 8 % kC, r = e / (8 * kC);
      const int R = r0 + r, t = R / G, col = 64 * c + 8 * j;
      v[i] = t < T_ && col < Dt
                 ? *reinterpret_cast<const uint4*>(
                       q + ((static_cast<int64_t>(b) * T_ + t) * H + h * G +
                            R % G) * Dt + col)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kConsumers;
      const int j = e % 8, c = e / 8 % kC, r = e / (8 * kC);
      *reinterpret_cast<uint4*>(base + (c * kTcRows + r) * kRowBytes +
                                16 * (j ^ (r % 8))) = v[i];
    }
    fence_proxy_async();
    consumers_sync();
  } else {
    warp_wait(ring.once(), 0);
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % kStages;
    warp_wait(ring.full(st), (kt / kStages) & 1);
    const uint32_t ks = kv0 + st * 2 * Sh::kKV, vs = ks + Sh::kKV;
    const int k0 = kt * kTcKeys;

    float s[32];
    zero(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<kTcRows>(qsm, kWgRows * g, kk),
                   desc_k<kTcKeys>(ks, 0, kk), kk > 0);
    wg_commit();
    wg_wait();
    keep(s);

    uint32_t pf[kTcKeys / 16][4];         // masked, P in bf16, acc rescaled
    softmax_tile<kC>(acc, s, m, lsum, pf, k0, S, S8, qpos, klast, first_wg,
                     scale2, l);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        wgmma_rs_n64(acc[c], pf[kk], desc_mn<kTcKeys>(vs, c, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < kC; ++c) keep(acc[c]);
    keep(pf);
    __syncwarp();
    if (l == 0) bar_arrive(ring.empty(st));
  }

  store_rows<kC>(acc, lsum, out, b, h, T_, H, G, F, Dt, r0, rl, 0, l);
}

// a contiguous bf16 tensor whose dims, innermost first, are `dims`, as a
// 4-D map with boxes of `box`, 128-byte swizzle; reads out of bounds
// fill zeros
int make_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
             const cuuint32_t (&box)[4]) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return kNoEncoder;
  const cuuint64_t row = dims[0] * 2;
  const cuuint64_t strides[3] = {row, row * dims[1], row * dims[1] * dims[2]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapFailed + static_cast<int>(r);
}

// Q's map (where G <= kWgRows) and the pools' maps of a call: boxes of
// (64, gp, rows / gp, 1) of a (Dt, H, T, B) q and (64, 1, br, 1) of the
// (Dt, KV, S, NP) pools
int make_maps(const Call& a, int rows, CUtensorMap* qm, CUtensorMap* km,
              CUtensorMap* vm) {
  const int G = a.H / a.KV, F = fold_of(G);
  const cuuint32_t br = box_rows(pad_slots(a.S));
  // q's and the pools' rows are Dt wide: the 64-column boxes read zeros
  // past Dt (and past D at D 32), so the tiles hold D columns
  const cuuint64_t dq[4] = {static_cast<cuuint64_t>(a.Dt),
                            static_cast<cuuint64_t>(a.H),
                            static_cast<cuuint64_t>(a.T),
                            static_cast<cuuint64_t>(a.B)};
  const cuuint64_t dp[4] = {static_cast<cuuint64_t>(a.Dt),
                            static_cast<cuuint64_t>(a.KV),
                            static_cast<cuuint64_t>(a.S),
                            static_cast<cuuint64_t>(a.NP)};
  const cuuint32_t bq[4] = {64, static_cast<cuuint32_t>(F),
                            static_cast<cuuint32_t>(rows / F), 1};
  const cuuint32_t bp[4] = {64, 1, br, 1};
  if (G <= kWgRows)                      // the flat fold has no Q map
    if (int e = make_map(qm, a.q, dq, bq)) return e;
  if (int e = make_map(km, a.kp, dp, bp)) return e;
  return make_map(vm, a.vp, dp, bp);
}

template <int D>
int launch(const Call& a) {
  using Sh = TcShape<D>;
  const int F = fold_of(a.H / a.KV);
  CUtensorMap qm{}, km, vm;
  if (int e = make_maps(a, kTcRows, &qm, &km, &vm)) return e;
  const size_t smem = Sh::smem(a.P);
  auto kernel = paged_prefill_tc_kernel<D>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(a.B * a.KV, (a.T * F + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      qm, km, vm, static_cast<const __nv_bfloat16*>(a.q), a.table,
      a.q_start, a.out, a.T, a.H, a.KV, a.Dt, a.S, a.P, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Tensor-core prefill past D 256 (bf16): the output's columns sliced

constexpr int kSlOwnMax = 4;       // 64-column output chunks a slice
constexpr int kSlMinStages = 4;    // ring stages beside a resident Q
constexpr int kSlMaxStages = 16;
constexpr int kSlConsumers = 128;  // one consumer warpgroup (header)
constexpr int kSlRows = kWgRows;   // folded rows a CTA
constexpr int kSlThreads = kSlConsumers + 64;   // + a K (and Q), a V warp
constexpr int kChunk = kTcKeys * kRowBytes;     // [64][64] bf16: 8 KB
constexpr int kQChunk = kSlRows * kRowBytes;    // a chunk of the CTA's Q

// output chunks a slice owns: the fewest slices of at most kSlOwnMax
// chunks, as even as they come (3 or 4 for every nc >= 5); the last
// slice's chunks past D are TMA's zeros, not stored
inline int sl_own(int nc) {
  const int fewest = (nc + kSlOwnMax - 1) / kSlOwnMax;
  return (nc + fewest - 1) / fewest;
}

// Shared memory: Q where resident (nc chunks), the V slice (OWN chunks),
// the ring of ns stages (a K chunk, and the step's Q chunk where Q is
// not resident), the barriers full[kSlMaxStages], empty[kSlMaxStages],
// vfull, vempty, then the page ids; 1024 bytes of alignment
__host__ __device__ constexpr int sl_q_bytes(int nc, bool q_res) {
  return q_res ? nc * kQChunk : 0;
}
__host__ __device__ constexpr int sl_stage_bytes(bool q_res) {
  return q_res ? kChunk : kChunk + kQChunk;
}
__host__ __device__ constexpr int sl_bars_at(int nc, int own, bool q_res,
                                             int ns) {
  return sl_q_bytes(nc, q_res) + own * kChunk + ns * sl_stage_bytes(q_res);
}
__host__ __device__ constexpr int sl_pages_at(int nc, int own, bool q_res,
                                              int ns) {
  return sl_bars_at(nc, own, q_res, ns) + 8 * (2 * kSlMaxStages + 2);
}
inline size_t sl_smem(int nc, int own, bool q_res, int ns, int P) {
  return 1024 + sl_pages_at(nc, own, q_res, ns) + static_cast<size_t>(P) * 4;
}

// One CTA per (row b, kv head; kSlRows folded query rows; a slice of OWN
// output chunks); see the header. D is the built head dim, a runtime
// multiple of 64.
template <int OWN>
__global__ void __launch_bounds__(kSlThreads, 1)
paged_prefill_sliced_tc_kernel(const __grid_constant__ CUtensorMap qm,
                               const __grid_constant__ CUtensorMap km,
                               const __grid_constant__ CUtensorMap vm,
                               const int* __restrict__ table,
                               const int* __restrict__ q_start,
                               float* __restrict__ out, int T_, int H,
                               int KV, int D, int Dt, int S, int P,
                               int q_res, int ns, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int nc = D / 64, tid = threadIdx.x, l = tid % 32;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qsm = base;                          // resident Q
  const uint32_t vb = base + sl_q_bytes(nc, q_res);   // [OWN][64][64]
  const uint32_t ring0 = vb + OWN * kChunk;
  const int stage_bytes = sl_stage_bytes(q_res);
  const uint32_t bars = base + sl_bars_at(nc, OWN, q_res, ns);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kSlMaxStages + s); };
  const uint32_t vfull = bars + 16 * kSlMaxStages, vempty = vfull + 8;
  int* const pages = reinterpret_cast<int*>(
      smem_raw + (base - smem_u32(smem_raw)) +
      sl_pages_at(nc, OWN, q_res, ns));

  const int b = blockIdx.x / KV, h = blockIdx.x % KV, G = H / KV;
  const int F = pad_group(G), S8 = pad_slots(S);   // G <= kWgRows
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kSlRows;  // most keys first
  const int t0 = r0 / F;                 // first query column
  const int tn = min(T_ - t0, (r0 + kSlRows - 1) / F - t0 + 1);  // columns
  const int col0 = 64 * OWN * blockIdx.z;

  // the ids of the pages the CTA reads (q_start counts them), staged in
  // shared memory before any load
  const int qs = q_start[b];
  const int first = qs + t0;             // the CTA's first query position
  const int n_pages = min(P, (first + tn - 1) / S + 1);
  const int* const row_table = table + static_cast<int64_t>(b) * P;
  for (int j = tid; j < n_pages; j += kSlThreads) pages[j] = row_table[j];
  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kSlConsumers / 32);
    }
    bar_init(vfull, 1);
    bar_init(vempty, kSlConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kend = n_pages * S8;         // padded keys loaded
  const int nkt = (kend + kTcKeys - 1) / kTcKeys;
  const int steps = nkt * nc;            // (key tile, 64-column chunk)
  const int br = box_rows(S8), nbox = kTcKeys / br;

  if (tid >= kSlConsumers) {
    // the producer warps; a tile's boxes are issued by a warp's lanes
    // together. Slots of pages < n_pages come from the pools, the rest
    // are boxes at page -1, out of bounds, which TMA fills with zeros,
    // as are rows past slot S - 1 of a page and columns past Dt
    if (tid < kSlConsumers + 32) {
      // step t's K chunk (Q's too: where Q is resident its chunk c comes
      // once, with the first key tile's step c, into its own place), each
      // stage refilled once the consumer warps released it
      for (int t = 0; t < steps; ++t) {
        const int st = t % ns, c = t % nc, k0 = t / nc * kTcKeys;
        const uint32_t dst = ring0 + st * stage_bytes;
        if (t >= ns) warp_wait(empty(st), (t / ns - 1) & 1);
        if (l == 0) {
          const bool q_now = !q_res || t < nc;
          bar_expect(full(st), kChunk + (q_now ? kQChunk : 0));
          const uint32_t qdst = q_res ? qsm + c * kQChunk : dst + kChunk;
          if (q_now) tma_load(qdst, &qm, full(st), 64 * c, h * G, t0, b);
        }
        __syncwarp();
        for (int e = l; e < nbox; e += 32) {
          const int k = k0 + e * br;
          tma_load(dst + e * br * kRowBytes, &km, full(st), 64 * c, h,
                   k % S8, k < kend ? pages[k / S8] : -1);
        }
      }
    } else {
      // each key tile's V slice, once the previous tile's P·V read it
      for (int kt = 0; kt < nkt; ++kt) {
        if (kt > 0) warp_wait(vempty, (kt - 1) & 1);
        if (l == 0) bar_expect(vfull, OWN * kChunk);
        __syncwarp();
        for (int e = l; e < OWN * nbox; e += 32) {
          const int j = e / nbox, k = kt * kTcKeys + e % nbox * br;
          tma_load(vb + j * kChunk + e % nbox * br * kRowBytes, &vm, vfull,
                   col0 + 64 * j, h, k % S8, k < kend ? pages[k / S8] : -1);
        }
      }
    }
    return;                              // no CTA barrier after this
  }

  // this thread's accumulator rows: folded rows rl and rl + 8 of the
  // tile, which starts at query position first_wg
  const int rl = 16 * (tid / 32) + l / 4;
  const int qpos[2] = {qs + (r0 + rl) / F, qs + (r0 + rl + 8) / F};
  const int first_wg = qs + r0 / F;
  const int klast = n_pages * S - 1;     // the last key loaded, unpadded
  const float scale2 = scale * 1.4426950408889634f;   // log2 e
  float acc[OWN][32], s[32], m[2] = {-INFINITY, -INFINITY};
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < OWN; ++j) zero(acc[j]);
  zero(s);

  // released by a warp once the products that read the stage are done
  auto release = [&](int t) {
    __syncwarp();
    if (l == 0) bar_arrive(empty(t % ns));
  };
  for (int t = 0; t < steps; ++t) {
    const int kt = t / nc, c = t % nc, st = t % ns;
    warp_wait(full(st), (t / ns) & 1);
    const uint32_t stage = ring0 + st * stage_bytes;
    const uint32_t qc = q_res ? qsm + c * kQChunk : stage + kChunk;
    // S = Q·Kᵀ over all of D, a 64-column chunk a step, in the same
    // order in every slice; step t - 1's group overlaps this one's
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(s, desc_k<kSlRows>(qc, 0, kk),
                   desc_k<kTcKeys>(stage, 0, kk), c > 0 || kk > 0);
    wg_commit();
    if (c > 0) {                         // step t - 1's chunk is read
      wg_wait<1>();
      release(t - 1);
    }
    if (c < nc - 1) continue;
    wg_wait();
    keep(s);
    release(t);

    uint32_t pf[kTcKeys / 16][4];       // masked, P in bf16, acc rescaled
    softmax_tile<OWN>(acc, s, m, lsum, pf, kt * kTcKeys, S, S8, qpos, klast,
                      first_wg, scale2, l);

    warp_wait(vfull, kt & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk)
#pragma unroll
      for (int j = 0; j < OWN; ++j)
        wgmma_rs_n64(acc[j], pf[kk], desc_mn<kTcKeys>(vb, j, kk));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < OWN; ++j) keep(acc[j]);
    keep(pf);
    __syncwarp();
    if (l == 0) bar_arrive(vempty);
  }

  store_rows<OWN>(acc, lsum, out, b, h, T_, H, G, F, Dt, r0, rl, col0,
                  l);
}

template <int OWN>
int launch_sliced_own(const Call& a, const CUtensorMap& qm,
                      const CUtensorMap& km, const CUtensorMap& vm) {
  const int nc = a.D / 64, nsl = (nc + OWN - 1) / OWN;
  // Q stays in shared memory where it fits beside the V slice, the page
  // ids and kSlMinStages stages of K, else comes with K a chunk a step;
  // the ring takes the rest, up to kSlMaxStages
  const bool q_res = sl_smem(nc, OWN, true, kSlMinStages, a.P) <= kSmemMax;
  const int ns = min(kSlMaxStages,
                     static_cast<int>((kSmemMax - sl_smem(nc, OWN, q_res, 0,
                                                          a.P)) /
                                      sl_stage_bytes(q_res)));
  const size_t smem = sl_smem(nc, OWN, q_res, ns, a.P);
  auto kernel = paged_prefill_sliced_tc_kernel<OWN>;
  if (int e = set_smem(kernel, smem)) return e;
  const dim3 grid(a.B * a.KV,
                  (a.T * pad_group(a.H / a.KV) + kSlRows - 1) / kSlRows, nsl);
  kernel<<<grid, kSlThreads, smem, a.stream>>>(
      qm, km, vm, a.table, a.q_start, a.out, a.T, a.H, a.KV, a.D, a.Dt, a.S,
      a.P, q_res, ns, a.scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_sliced(const Call& a) {
  CUtensorMap qm, km, vm;
  if (int e = make_maps(a, kWgRows, &qm, &km, &vm)) return e;
  if (sl_own(a.D / 64) == 3) return launch_sliced_own<3>(a, qm, km, vm);
  return launch_sliced_own<4>(a, qm, km, vm);
}

}  // namespace tc

enum Route { kRouteSplit = 0, kRouteTc = 1, kRouteRow = 2,
             kRouteRowSliced = 3, kRouteTcSliced = 4 };

// the head dim a call of true head dim Dt runs at: the smallest of 32,
// 64, 128, 192 and 256 not below it, past 256 the next multiple of 64
// (the wide and sliced kernels take any multiple of 64)
int built_dim(int Dt) {
  if (Dt > kRowOnlyPast) return (Dt + 63) / 64 * 64;
  return Dt <= 32 ? 32 : Dt <= 64 ? 64 : Dt <= 128 ? 128 : Dt <= 192 ? 192
                                                                     : 256;
}

// past D 256, the calls the sliced tensor-core prefill takes
// (tc::paged_prefill_sliced_tc_kernel): bf16 pools whose rows are
// 16-byte multiples (TMA maps), tables it stages (kTcMaxPages) and G it
// folds by boxes (up to kWgRows). Decode too (T·G <= kSplitRows): its
// 64-row tile holds at most 16 real rows, but it took the bf16 decode
// cases past 256 in 0.20-0.22x the row-tile kernels' time (D 288-1856,
// scripts/paged_ab.py --tc-sliced, one NVIDIA H100 80GB HBM3, 700 W).
// The rest stay on the row-tile kernels: f32 pools, unaligned rows,
// longer tables and G past 64
bool takes_tc_sliced(int dtype, int G, int Dt, int P) {
  return dtype == 1 && Dt * 2 % 16 == 0 && P <= tc::kTcMaxPages &&
         G <= tc::kWgRows;
}

// the kernel a call runs, by dtype and shape alone: by the built head
// dim, except that a pool row of Dt·elt bytes that is no multiple of 16
// (bf16 Dt % 8 != 0, f32 Dt % 4 != 0) cannot be read in the split
// kernel's 16-byte copies nor be a TMA map's row (its strides must be
// multiples of 16 bytes), so such calls take the row-tile kernel, which
// stages those rows element by element
Route route_of(int dtype, int T, int H, int KV, int Dt, int S, int P) {
  const int G = H / KV, D = built_dim(Dt), elt = dtype == 0 ? 4 : 2;
  if (D > kRowOnlyPast) {
    if (takes_tc_sliced(dtype, G, Dt, P)) return kRouteTcSliced;
    return D > wide_max_d(elt) ? kRouteRowSliced : kRouteRow;
  }
  if (Dt * elt % 16 != 0) return kRouteRow;
  if (T * G <= kSplitRows) return kRouteSplit;
  if (dtype == 1 && P <= tc::kTcMaxPages) return kRouteTc;
  return kRouteRow;
}

template <typename T, int D>
int launch_call(const Call& a, Route route) {
  if (route == kRouteSplit) {
    if (a.ws == nullptr || a.counters == nullptr || a.pps < 1) return -3;
    const int rows = a.T * (a.H / a.KV);
    return rows <= 4 ? launch_split<T, D, 4>(a) : launch_split<T, D, 16>(a);
  }
  if (route == kRouteTc) {
    if constexpr (sizeof(T) == 2) {
      const int e = tc::launch<D>(a);
      return e == hopper::kNoEncoder ? -5 : e;
    }
    return -2;
  }
  return launch<T, D, 4>(a.q, a.kp, a.vp, a.table, a.q_start, a.out, a.B,
                         a.T, a.H, a.KV, a.Dt, a.S, a.P, a.scale, a.stream);
}

template <typename T>
int launch_dims(const Call& a, Route route) {
  switch (a.D) {
    case 32:
      return launch_call<T, 32>(a, route);
    case 64:
      return launch_call<T, 64>(a, route);
    case 128:
      return launch_call<T, 128>(a, route);
    case 192:
      return launch_call<T, 192>(a, route);
    case 256:
      return launch_call<T, 256>(a, route);
    default:             // past 256: the tensor-core prefill sliced,
                         // or the row-tile kernel, wide or sliced
      if (a.D <= kRowOnlyPast) return -1;
      if (route == kRouteTcSliced) {
        if constexpr (sizeof(T) == 2) {
          const int e = tc::launch_sliced(a);
          return e == hopper::kNoEncoder ? -5 : e;
        }
        return -2;
      }
      if (route == kRouteRowSliced)
        return launch_sliced<T>(a.q, a.kp, a.vp, a.table, a.q_start, a.out,
                                a.B, a.T, a.H, a.KV, a.D, a.Dt, a.S, a.P,
                                a.scale, a.stream);
      if (route != kRouteRow) return -1;
      return launch_wide<T>(a.q, a.kp, a.vp, a.table, a.q_start, a.out, a.B,
                            a.T, a.H, a.KV, a.D, a.Dt, a.S, a.P, a.scale,
                            a.stream);
  }
}

}  // namespace

// dtype: 0 = float32 pools, 1 = bfloat16 pools; D: the head dim of q,
// the pools and out, any D >= 1 (the call runs at built_dim(D), its
// columns past D zeros that are never stored); NP: pages in each pool.
// Writes the route the call takes to *route (0 split-KV, 1 tensor-core
// prefill, 2 row-tile, 3 row-tile with its columns sliced, 4 tensor-core
// prefill with its columns sliced; route_of)
// before launching. A split call (T·G <=
// 16 query rows per kv head) needs `ws`, an f32 workspace of
// B·KV·ceil(P/pps)·T·G·(built_dim(D) + 2) elements, `counters`, B·KV
// ints that are 0 (the kernel leaves them 0), and `pps` pages per split;
// the other routes leave ws, counters and pps unused. Returns 0 on a
// clean launch, -1 for a head dim below 1, -2 for another dtype, -3
// for a split call without a workspace, counters or pages per split, -4
// for a split whose page ids do not fit shared memory, -5 where the
// driver offers no tensor-map encoder, 1000 + the CUresult of a tensor
// map the driver refused, else the CUDA error code of the launch.
extern "C" int bigdl_paged_attention(int dtype, const void* q,
                                     const void* kp, const void* vp,
                                     const int* table, const int* q_start,
                                     float* out, float* ws, int* counters,
                                     int* route, int B, int T, int H, int KV,
                                     int D, int S, int P, int NP, int pps,
                                     float scale, void* stream) {
  if (D < 1) return -1;
  const Call a{q, kp, vp, table, q_start, out, ws, counters, B, T, H, KV,
               built_dim(D), D, S, P, NP, pps, scale,
               static_cast<cudaStream_t>(stream)};
  const Route r = route_of(dtype, T, H, KV, D, S, P);
  *route = r;
  if (dtype == 0) return launch_dims<float>(a, r);
  if (dtype == 1) return launch_dims<__nv_bfloat16>(a, r);
  return -2;
}

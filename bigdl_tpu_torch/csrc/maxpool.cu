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
// Out-of-image x is -inf and out-of-image dy is 0, which reproduces the
// SAME padding (maxpool.py:92-114).
//
// Design (simple and right first):
// - Gather form, no atomics: one thread per input element p. For each of
//   the nine windows that cover p, in the order of the TPU kernel's
//   offsets (so the f32 sum is taken in the plain version's order), the
//   thread finds the window's first maximal position and adds dy when
//   that position is p.
// - A block of 256 threads owns a TH x TW tile of PB (n, c) planes (TW 8,
//   16 or 32 to fit W, TH to fit H, PB = 256 / (TW*TH): small planes share
//   a block). It stages x with a 2-row/col halo and y, dy with a 1-row/col
//   halo in shared memory, as f32 (exact for both dtypes, so comparing
//   there is comparing in the input dtype).
// - dx is accumulated in f32 and rounded once.
//
// Bound on the H100: bytes (read x, y, dy, write dx, each once). The
// compares, up to 81 per element from shared memory, are what this simple
// form spends beyond that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// stage a (rows x cols) window of PB planes, origin (h0, w0), into smem;
// out-of-image (or past the last plane) elements take `fill`
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int64_t plane0, int64_t planes, int H,
                                      int W, int h0, int w0, int rows,
                                      int cols, int PB, float fill) {
  const int per = rows * cols;
  for (int e = threadIdx.x; e < PB * per; e += kThreads) {
    const int pl = e / per, rem = e - pl * per;
    const int h = h0 + rem / cols, w = w0 + rem % cols;
    const int64_t plane = plane0 + pl;
    float v = fill;
    if (plane < planes && h >= 0 && h < H && w >= 0 && w < W)
      v = to_f32(src[(plane * H + h) * W + w]);
    dst[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool3x3s1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            int64_t planes, int H, int W, int TH, int TW,
                            int PB, int tiles_w) {
  extern __shared__ float smem[];
  const int XH = TH + 4, XW = TW + 4, YH = TH + 2, YW = TW + 2;
  float* xs = smem;                  // [PB][XH][XW], origin (h0-2, w0-2)
  float* ys = xs + PB * XH * XW;     // [PB][YH][YW], origin (h0-1, w0-1)
  float* gs = ys + PB * YH * YW;     // same
  const int h0 = (blockIdx.y / tiles_w) * TH;
  const int w0 = (blockIdx.y % tiles_w) * TW;
  const int64_t plane0 = (int64_t)blockIdx.x * PB;
  stage(x, xs, plane0, planes, H, W, h0 - 2, w0 - 2, XH, XW, PB, -INFINITY);
  stage(y, ys, plane0, planes, H, W, h0 - 1, w0 - 1, YH, YW, PB, -INFINITY);
  stage(dy, gs, plane0, planes, H, W, h0 - 1, w0 - 1, YH, YW, PB, 0.0f);
  __syncthreads();

  const int pl = threadIdx.x / (TW * TH);
  const int rem = threadIdx.x - pl * (TW * TH);
  const int ty = rem / TW, tx = rem % TW;
  const int64_t plane = plane0 + pl;
  const int h = h0 + ty, w = w0 + tx;
  if (pl >= PB || plane >= planes || h >= H || w >= W) return;
  const float* xp = xs + pl * XH * XW;
  const float* yp = ys + pl * YH * YW;
  const float* gp = gs + pl * YH * YW;

  float acc = 0.0f;
  // p is at offset (dr, dc) of the window centred at (h-dr, w-dc); the
  // offsets in row-major order, as the TPU kernel's loop
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int oh = h - (q / 3 - 1), ow = w - (q % 3 - 1);
    if (oh < 0 || oh >= H || ow < 0 || ow >= W) continue;
    const int yi = (oh - h0 + 1) * YW + (ow - w0 + 1);
    const float yv = yp[yi];
    // the window's first position (row-major) holding its max
    const float* xw = xp + (oh - h0 + 1) * XW + (ow - w0 + 1);
    int first = 9;
#pragma unroll
    for (int f = 0; f < 9; ++f) {
      if (xw[(f / 3) * XW + f % 3] == yv) {
        first = f;
        break;
      }
    }
    if (first == q) acc += gp[yi];
  }
  dx[(plane * H + h) * W + w] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* y, const void* dy, void* dx, int N,
           int C, int H, int W, cudaStream_t st) {
  int TW = 32;
  while (TW > 8 && TW / 2 >= W) TW /= 2;
  int TH = kThreads / TW;
  while (TH > 1 && TH / 2 >= H) TH /= 2;
  const int PB = kThreads / (TW * TH);
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t planes = (int64_t)N * C;
  const int64_t blocks = (planes + PB - 1) / PB;
  if ((int64_t)tiles_w * tiles_h > 65535 || blocks > 0x7fffffff) return -3;
  const size_t smem = sizeof(float) * PB
                      * ((TH + 4) * (TW + 4) + 2 * (TH + 2) * (TW + 2));
  dim3 grid((unsigned)blocks, (unsigned)(tiles_w * tiles_h));
  maxpool3x3s1_bwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(dy), static_cast<T*>(dx), planes, H, W, TH, TW,
      PB, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x, y, dy, dx: contiguous (N, C, H, W) of
// one dtype (y the forward's output). Returns 0, or a CUDA error code
// (negative: unsupported dtype / grid).
extern "C" int bigdl_maxpool3x3s1_bwd(int dtype, const void* x, const void* y,
                                      const void* dy, void* dx, int N, int C,
                                      int H, int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, dy, dx, N, C, H, W, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, dy, dx, N, C, H, W, st);
  return -2;
}

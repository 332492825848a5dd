// Tile-binned general-conic accumulation, forward (K8a).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/binned.py:_binned_fwd_kernel,
// launched there by _binned_call (via _binned_fwd_call). Per 16x128-pixel
// tile t (pixel centres at +0.5), over the 512-slot chunks j of its slot list
// with j * 512 < cnt[t] (later chunks are skipped, as on the TPU):
//
//   e = -0.5 (a dx^2 + 2 b dx dy + c dy^2)      (the conic as binned: unscaled)
//   w = op * exp(e)                              (no cutoff, no clamp)
//   acc[f, p] += feats_f * w                     (feats not pre-multiplied)
//
// and writes acc (8, n_tiles*2048), pixel l of tile t at column t*2048 + l
// (l = row*128 + col). Slots past cnt inside a processed chunk are the dead
// row (op 0), which adds exact zeros.
//
// Bound: f32 ALU work, 22 flops (a multiply-add counted as 2) and one exp per
// (slot, pixel) pair of the processed chunks: dy, the exponent as two
// multiply-adds on per-slot coefficients, op * exp and 8 multiply-adds;
// against 64 B read per slot and 32 B written per pixel. Operations bound
// it. Design: one block per tile, 512 threads that each own 4 pixels of one
// column (rows r0, r0+4, r0+8, r0+12), so dx and the per-slot coefficients
// -a dx^2 / 2, -b dx are computed once per slot and thread; the tile's rows
// stream through shared memory 128 at a time and every thread reads them by
// broadcast. The 32 sums stay in registers; each pixel's sum runs in slot
// order, so two launches give the same bits. f32 throughout, expf (no fast
// math).
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows [px, py, conic_a,
// conic_b, conic_c, op, feats(8), 0, 0] (ops/sorted.pack_gdata gathered by
// the binner's slots); cnt (n_tiles,) int32; cap a multiple of 512. Build:
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;           // tile height (rows)
constexpr int TWC = 128;         // tile width (columns)
constexpr int TPS = TH * TWC;    // pixels per tile
constexpr int NBS = 512;         // slots per chunk
constexpr int GD = 16;           // floats per slot row
constexpr int FEAT = 8;          // output rows
constexpr int THREADS = 512;
constexpr int PPT = TPS / THREADS;       // pixels per thread (4)
constexpr int RSTEP = THREADS / TWC;     // row step between a thread's pixels
constexpr int SB = 128;          // slots staged at a time

__global__ void __launch_bounds__(THREADS)
binned_fwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt, float* __restrict__ out,
                  int tiles_x, int n_tiles, int cap) {
  __shared__ float4 rows[SB * GD / 4];       // 8 KB

  const int tile = blockIdx.x;
  const int col = threadIdx.x % TWC;
  const int row0 = threadIdx.x / TWC;
  const float gx = static_cast<float>((tile % tiles_x) * TWC + col) + 0.5f;
  const int gy0 = (tile / tiles_x) * TH + row0;
  float gy[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
    gy[i] = static_cast<float>(gy0 + RSTEP * i) + 0.5f;

  float acc[PPT][FEAT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int f = 0; f < FEAT; ++f) acc[i][f] = 0.f;

  // Whole chunks below cnt, as the TPU grid.
  const int n_slots = min(((min(cnt[tile], cap) + NBS - 1) / NBS) * NBS, cap);
  const float4* src = reinterpret_cast<const float4*>(
      gdense + static_cast<size_t>(tile) * cap * GD);
  for (int base = 0; base < n_slots; base += SB) {
    __syncthreads();   // the previous rows' reads are over
    for (int k = threadIdx.x; k < SB * (GD / 4); k += THREADS)
      rows[k] = src[static_cast<size_t>(base) * (GD / 4) + k];
    __syncthreads();
    for (int s = 0; s < SB; ++s) {
      const float4 h0 = rows[s * 4 + 0];    // px, py, a, b
      const float4 h1 = rows[s * 4 + 1];    // c, op, f0, f1
      const float4 h2 = rows[s * 4 + 2];    // f2 .. f5
      const float4 h3 = rows[s * 4 + 3];    // f6, f7, 0, 0
      const float fe[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};
      const float dx = gx - h0.x;
      const float e0 = -0.5f * (h0.z * dx * dx);   // -a dx^2 / 2
      const float e1 = -(h0.w * dx);               // -b dx
      const float e2 = -0.5f * h1.x;               // -c / 2
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dy = gy[i] - h0.y;
        const float w = h1.y * expf(fmaf(fmaf(e2, dy, e1), dy, e0));
#pragma unroll
        for (int f = 0; f < FEAT; ++f) acc[i][f] = fmaf(fe[f], w, acc[i][f]);
      }
    }
  }

  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  float* o = out + static_cast<size_t>(tile) * TPS + row0 * TWC + col;
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int f = 0; f < FEAT; ++f)
      o[f * plane + RSTEP * i * TWC] = acc[i][f];
}

}  // namespace

extern "C" cudaError_t binned_fwd_launch(const float* gdense, const int* cnt,
                                         float* out, int tiles_x, int n_tiles,
                                         int cap, cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  binned_fwd_kernel<<<n_tiles, THREADS, 0, stream>>>(gdense, cnt, out,
                                                      tiles_x, n_tiles, cap);
  return cudaGetLastError();
}

// Tile-binned general-conic accumulation, backward (K8b).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/binned.py:_binned_bwd_kernel,
// launched there by _binned_call (via _binned_bwd_call). Given the cotangent
// g8 (8, n_tiles*2048) of K8a's output (binned_fwd.cu), for each slot of the
// 512-slot chunks j of tile t with j * 512 < cnt[t], summed over the tile's
// 2048 pixels (centres at +0.5), with e and w as in K8a:
//
//   g_w = sum_f g8[f, p] feats_f,   g_e = w g_w
//   M0 = sum g_e, Mdx = sum g_e dx, Mdy = sum g_e dy, Mxx = sum g_e dx^2,
//   Mxy = sum g_e dx dy, Myy = sum g_e dy^2,   g_feat_f = sum_p g8[f, p] w
//
// and writes the slot's row [Mdx, Mdy, Mxx, Mxy, Myy, M0, g_feat(8), 0, 0] of
// out (n_tiles*cap, 16). The rows of a chunk at or past cnt[t] are zero. A
// dead slot (op 0) has w = 0, so its row is zero too. ops/sorted.
// moment_postpass turns the moments into gradients of the slot rows.
//
// Design. Each slot belongs to one tile and one chunk, so a block per
// (tile, chunk) owns its 512 output rows: no cross-block hazard, no atomics,
// and two launches give the same bits. A thread per slot keeps the 14 sums in
// registers; the tile's g8 (2048 pixels x 8 floats, 64 KB of dynamic shared
// memory, opted in on every launch) is staged pixel-major and read by
// broadcast, two float4 per pixel. The pixels run row by row: the y terms
// (-b dy, -c dy^2 / 2) are per row, and per row the thread sums g_e, g_e dx
// and g_e dx^2, folding dy in at the row's end (Mdy, Mxy, Myy). f32
// throughout, fmaf and expf (no fast math).
//
// Bound: f32 ALU work, 44 flops (a multiply-add counted as 2) and one exp per
// (slot, pixel) pair of the processed chunks: dx, the exponent (two
// multiply-adds), op * exp, g_w (8 multiply-adds), g_e, the three row sums
// and u = g_e dx (5) and g_feat (8 multiply-adds); against 64 B read and
// written per slot and the tile's g8 (32 B per pixel) read once. Operations
// bound it.
//
// Inputs: gdense, cnt as K8a; g8 (8, n_tiles*2048) f32, pixel l of tile t at
// column t*2048 + l. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;           // tile height (rows)
constexpr int TWC = 128;         // tile width (columns)
constexpr int TPS = TH * TWC;    // pixels per tile
constexpr int NBS = 512;         // slots per chunk = threads per block
constexpr int GD = 16;           // floats per slot row
constexpr int FEAT = 8;          // cotangent rows
constexpr size_t SMEM = TPS * FEAT * sizeof(float);   // 64 KB

__global__ void __launch_bounds__(NBS)
binned_bwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt, const float* __restrict__ g8,
                  float* __restrict__ out, int tiles_x, int n_tiles, int cap) {
  extern __shared__ float4 gs[];             // [pixel][f]: 2 float4 per pixel
  float* gsf = reinterpret_cast<float*>(gs);

  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const size_t slot = static_cast<size_t>(tile) * cap + chunk * NBS + threadIdx.x;
  float4* dst = reinterpret_cast<float4*>(out + slot * GD);
  if (chunk * NBS >= min(cnt[tile], cap)) {   // uniform in the block
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    dst[0] = zero; dst[1] = zero; dst[2] = zero; dst[3] = zero;
    return;
  }

  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  const float* gt = g8 + static_cast<size_t>(tile) * TPS;
  for (int k = threadIdx.x; k < TPS * FEAT; k += NBS) {
    const int f = k / TPS, l = k % TPS;
    gsf[l * FEAT + f] = gt[f * plane + l];
  }

  const float4* row = reinterpret_cast<const float4*>(gdense + slot * GD);
  const float4 h0 = row[0], h1 = row[1], h2 = row[2], h3 = row[3];
  const float px = h0.x, py = h0.y, b = h0.w, c = h1.x, op = h1.y;
  const float ah = -0.5f * h0.z;              // -a / 2
  const float fe[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};
  const int x0 = (tile % tiles_x) * TWC;
  const int y0 = (tile / tiles_x) * TH;
  __syncthreads();

  float mdx = 0.f, mdy = 0.f, mxx = 0.f, mxy = 0.f, myy = 0.f, m0 = 0.f;
  float gf[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) gf[f] = 0.f;
  for (int r = 0; r < TH; ++r) {
    const float dy = (static_cast<float>(y0 + r) + 0.5f) - py;
    const float ey = -(b * dy);               // -b dy
    const float ec = -0.5f * (c * dy * dy);   // -c dy^2 / 2
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;       // sum g_e, g_e dx, g_e dx^2
    const float4* gp = gs + r * TWC * 2;
#pragma unroll 4
    for (int cx = 0; cx < TWC; ++cx) {
      const float dx = (static_cast<float>(x0 + cx) + 0.5f) - px;
      const float w = op * expf(fmaf(fmaf(ah, dx, ey), dx, ec));
      const float4 q0 = gp[cx * 2 + 0], q1 = gp[cx * 2 + 1];
      const float g[FEAT] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float gw = 0.f;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gw = fmaf(g[f], fe[f], gw);
      const float ge = w * gw;
      const float u = ge * dx;
      s0 += ge;
      s1 += u;
      s2 = fmaf(u, dx, s2);
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gf[f] = fmaf(g[f], w, gf[f]);
    }
    m0 += s0;
    mdx += s1;
    mxx += s2;
    mdy = fmaf(s0, dy, mdy);
    myy = fmaf(s0 * dy, dy, myy);
    mxy = fmaf(s1, dy, mxy);
  }

  dst[0] = make_float4(mdx, mdy, mxx, mxy);
  dst[1] = make_float4(myy, m0, gf[0], gf[1]);
  dst[2] = make_float4(gf[2], gf[3], gf[4], gf[5]);
  dst[3] = make_float4(gf[6], gf[7], 0.f, 0.f);
}

}  // namespace

extern "C" cudaError_t binned_bwd_launch(const float* gdense, const int* cnt,
                                         const float* g8, float* out,
                                         int tiles_x, int n_tiles, int cap,
                                         cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      binned_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  binned_bwd_kernel<<<dim3(n_tiles, cap / NBS), NBS, SMEM, stream>>>(
      gdense, cnt, g8, out, tiles_x, n_tiles, cap);
  return cudaGetLastError();
}

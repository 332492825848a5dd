// Tile-binned separable (axis footprint) accumulation, backward (K7b).
//
// Replaces the TPU kernel
// tpu_gaussians/ops/pallas/binned.py:_binned_bwd_kernel_sep, launched there
// by _binned_call via _binned_bwd_call(sep=True). Given the cotangent g8
// (8, n_tiles*2048) of K7a's output (binned_sep_fwd.cu), read as
// gband[f, r, c] per 16x128-pixel tile, and for each slot of the 512-slot
// chunks j of tile t with j * 512 < cnt[t], with Ex, Ey, featsop as in K7a
// and tx = x_c - px, ty = y_r - py:
//
//   gG2[f, r] = sum_c gband[f, r, c] Ex[c]              (TPU: gband . Ex)
//   gEx[c]    = sum_(f, r) gband[f, r, c] featsop_f Ey[r] (TPU: gband^T . G2)
//   g_featop_f = sum_r gG2[f, r] Ey[r],  gEy[r] = sum_f gG2[f, r] featsop_f
//   u_x = gEx Ex: Mdx = sum_c u_x tx, Mxx = sum_c u_x tx^2
//   u_y = gEy Ey: Mdy = sum_r u_y ty, Myy = sum_r u_y ty^2
//
// and writes the slot's row [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop(8), 0, 0] of
// out (n_tiles*cap, 16). The rows of a chunk at or past cnt[t] are zero.
// ops/binned.moment_postpass_opfold turns the rows into gradients of the slot
// rows (g_feat = op g_featop, g_op = sum_f feats_f g_featop_f).
//
// Design. Each slot belongs to one tile and one chunk, so a block per
// (tile, chunk) owns its 512 output rows, a thread per slot: no cross-block
// hazard, no atomics, two launches give the same bits. The tile's cotangent
// (2048 pixels x 8 floats, 64 KB of dynamic shared memory, opted in on every
// launch) is staged pixel-major and read by broadcast, two float4 per pixel.
// The separable structure stays: a thread evaluates 16 exps (Ey, kept in
// registers) and one per column (Ex), 144 per slot instead of 2048. The two
// factor products need 128 values each per slot, too many for registers, so
// the sums are regrouped (exactly, by linearity) around h[r, c] =
// sum_f gband[f, r, c] featsop_f: walking columns in order and rows inside,
//   gEx[c] = sum_r Ey[r] h[r, c]           (one column at a time),
//   gEy[r] = sum_c Ex[c] h[r, c]           (16 sums in registers),
//   g_featop_f = sum_c Ex[c] sum_r gband[f, r, c] Ey[r]  (8 + 8 sums).
// f32 throughout, fmaf and expf (no fast math), nothing cut off.
//
// Bound: f32 ALU work, 32 flops (a multiply-add counted as 2) per (slot,
// pixel) pair of the processed chunks, counted from the function's two
// products, gG2 = gband . Ex and gEx = gband^T . G2, one multiply-add per
// feature each; the per-slot terms and the 144 exps per slot are not
// counted. The regrouped loop above does 37: h (8 multiply-adds), gEx and
// gEy (2), the row sums of gband Ey (8), and per column g_featop (8
// multiply-adds over 16 rows). Against 64 B read and written per slot and
// the tile's g8 (32 B per pixel) read once, operations bound it.
//
// Inputs: gdense, cnt as K7a; g8 (8, n_tiles*2048) f32, pixel l = r*128 + c
// of tile t at column t*2048 + l. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC.

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
binned_sep_bwd_kernel(const float* __restrict__ gdense,
                      const int* __restrict__ cnt,
                      const float* __restrict__ g8, float* __restrict__ out,
                      int tiles_x, int n_tiles, int cap) {
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
  const float px = h0.x, py = h0.y, op = h1.y;
  const float ah = -0.5f * h0.z;              // -a / 2
  const float ch = -0.5f * h1.x;              // -c / 2
  const float fe[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};
  float fo[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) fo[f] = fe[f] * op;
  const int x0 = (tile % tiles_x) * TWC;
  const int y0 = (tile / tiles_x) * TH;
  float ey[TH];
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const float ty = (static_cast<float>(y0 + r) + 0.5f) - py;
    ey[r] = expf(ch * (ty * ty));
  }
  __syncthreads();

  float gey[TH];
#pragma unroll
  for (int r = 0; r < TH; ++r) gey[r] = 0.f;
  float gfo[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) gfo[f] = 0.f;
  float mdx = 0.f, mxx = 0.f;
  for (int cx = 0; cx < TWC; ++cx) {
    const float tx = (static_cast<float>(x0 + cx) + 0.5f) - px;
    const float ex = expf(ah * (tx * tx));
    float tmp[FEAT];
#pragma unroll
    for (int f = 0; f < FEAT; ++f) tmp[f] = 0.f;
    float gex = 0.f;
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const float4 q0 = gs[(r * TWC + cx) * 2 + 0];
      const float4 q1 = gs[(r * TWC + cx) * 2 + 1];
      const float g[FEAT] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float h = 0.f;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) h = fmaf(g[f], fo[f], h);
      gex = fmaf(h, ey[r], gex);
      gey[r] = fmaf(h, ex, gey[r]);
#pragma unroll
      for (int f = 0; f < FEAT; ++f) tmp[f] = fmaf(g[f], ey[r], tmp[f]);
    }
#pragma unroll
    for (int f = 0; f < FEAT; ++f) gfo[f] = fmaf(tmp[f], ex, gfo[f]);
    const float t1 = (gex * ex) * tx;
    mdx += t1;
    mxx = fmaf(t1, tx, mxx);
  }
  float mdy = 0.f, myy = 0.f;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const float ty = (static_cast<float>(y0 + r) + 0.5f) - py;
    const float t2 = (gey[r] * ey[r]) * ty;
    mdy += t2;
    myy = fmaf(t2, ty, myy);
  }

  dst[0] = make_float4(mdx, mdy, mxx, 0.f);
  dst[1] = make_float4(myy, 0.f, gfo[0], gfo[1]);
  dst[2] = make_float4(gfo[2], gfo[3], gfo[4], gfo[5]);
  dst[3] = make_float4(gfo[6], gfo[7], 0.f, 0.f);
}

}  // namespace

extern "C" cudaError_t binned_sep_bwd_launch(const float* gdense,
                                             const int* cnt, const float* g8,
                                             float* out, int tiles_x,
                                             int n_tiles, int cap,
                                             cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      binned_sep_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  binned_sep_bwd_kernel<<<dim3(n_tiles, cap / NBS), NBS, SMEM, stream>>>(
      gdense, cnt, g8, out, tiles_x, n_tiles, cap);
  return cudaGetLastError();
}

// General-conic accumulation over a (pixel tile x gaussian block) grid,
// backward (K9b).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_bwd_kernel,
// launched there by _bwd_call. Given the cotangent g8 (8, n_tiles*tp) of
// K9a's output (splat_v1_fwd.cu), for each gaussian of block j and each tile
// i with mask[i, j] set (pixels i*tp ..., centres at +0.5), with e and
// w = op exp(e) as in K9a:
//
//   g_w = sum_f g8[f, p] feats_f,   g_e = w g_w
//   g_px = sum g_e (a dx + b dy),   g_py = sum g_e (b dx + c dy)
//   g_a = -sum g_e dx^2 / 2, g_b = -sum g_e dx dy, g_c = -sum g_e dy^2 / 2
//   g_op = sum exp(e) g_w,          g_feat_f = sum_p g8[f, p] w
//
// summed over every pixel of those tiles, and writes the gaussian's row
// [g_px, g_py, g_a, g_b, g_c, g_op, g_feat(8), 0, 0] of out (n_pad, 16): the
// gradients themselves, no post-pass. Rows of blocks that no tile's mask
// holds are zero.
//
// Design. The TPU adds each tile's contribution into a resident output row
// block across a tile grid that runs in order; CUDA blocks run concurrently
// and in no order. So the kernel is gaussian-major and deterministic without
// atomics, as K6 (splat_v2_bwd.cu): a block of 128 threads owns 128
// gaussians of one nb-block (a thread per gaussian; 1M gaussians give 7,813
// blocks) and walks, in tile order, the tiles whose mask holds that block.
// For each it stages the tile's cotangent (tp pixels x 8 floats, at most
// 64 KB of dynamic shared memory, opted in on every launch) pixel-major;
// every thread reads it by broadcast, two float4 per pixel. Each thread sums
// g_e dx, g_e dy, g_e dx^2, g_e dx dy, g_e dy^2, exp(e) g_w and g_feat in
// registers, in two levels as K9a: over each tile's pixels in order, then
// the tiles' partial sums in tile order; and it turns the five moments into
// the conic's and the position's gradients once at the end (linear in them:
// g_px = a sum g_e dx + b sum g_e dy, ...). f32 throughout, fmaf and expf (no
// fast math), nothing cut off.
//
// Bound: f32 ALU work, 55 flops (a multiply-add counted as 2) and one exp per
// (gaussian, pixel) pair of the active (tile, block) pairs: dx, dy, the
// Horner exponent (7), op * exp, g_w (8 multiply-adds), g_e, exp(e) g_w (a
// multiply-add), u = g_e dx and v = g_e dy, the five moment sums (8) and
// g_feat (8 multiply-adds); against 64 B read and written per gaussian and
// g8 (32 B per pixel) read once. Operations bound it.
//
// Inputs: mask (n_tiles, n_blocks) uint8; gdata (n_blocks*nb, 16) f32 rows
// [px, py, a, b, c, op, feats(8), 0, 0]; g8 (8, n_tiles*tp) f32; nb and tp
// multiples of 128, tp at most 2048. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int KG = 128;            // gaussians (threads) per block; nb % KG == 0
constexpr int GD = 16;             // floats per gaussian row
constexpr int FEAT = 8;            // cotangent rows
constexpr int TP_MAX = 2048;       // largest tile
constexpr size_t SMEM_MAX = TP_MAX * FEAT * sizeof(float);   // 64 KB

__global__ void __launch_bounds__(KG)
splat_v1_bwd_kernel(const unsigned char* __restrict__ mask,
                    const float* __restrict__ gdata,
                    const float* __restrict__ g8, float* __restrict__ out,
                    int n_tiles, int n_blocks, int width, int nb, int tp) {
  extern __shared__ float4 gs[];            // [pixel][f] of the tile
  float* gsf = reinterpret_cast<float*>(gs);

  const int gi = blockIdx.x * KG + threadIdx.x;
  const int blk = blockIdx.x * KG / nb;     // the nb-block of all 128
  const size_t hw_pad = static_cast<size_t>(n_tiles) * tp;
  const float4* row = reinterpret_cast<const float4*>(
      gdata + static_cast<size_t>(gi) * GD);
  const float4 h0 = row[0], h1 = row[1], h2 = row[2], h3 = row[3];
  const float px = h0.x, py = h0.y, a = h0.z, b = h0.w, c = h1.x, op = h1.y;
  const float ah = -0.5f * a, bh = -b, ch = -0.5f * c;
  const float fe[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};

  float mdx = 0.f, mdy = 0.f, mxx = 0.f, mxy = 0.f, myy = 0.f, sop = 0.f;
  float gf[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) gf[f] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (!mask[static_cast<size_t>(tile) * n_blocks + blk]) continue;  // uniform
    __syncthreads();   // the previous tile's reads are over
    const float* gt = g8 + static_cast<size_t>(tile) * tp;
    for (int k = threadIdx.x; k < tp * FEAT; k += KG) {
      const int f = k / tp, l = k % tp;
      gsf[l * FEAT + f] = gt[f * hw_pad + l];
    }
    __syncthreads();
    const int p0 = tile * tp;
    int col = p0 % width;
    float gy = static_cast<float>(p0 / width) + 0.5f;
    float tdx = 0.f, tdy = 0.f, txx = 0.f, txy = 0.f, tyy = 0.f, top = 0.f;
    float tf[FEAT];
#pragma unroll
    for (int f = 0; f < FEAT; ++f) tf[f] = 0.f;
#pragma unroll 2
    for (int l = 0; l < tp; ++l) {
      const float dx = (static_cast<float>(col) + 0.5f) - px;
      const float dy = gy - py;
      if (++col == width) { col = 0; gy += 1.f; }
      const float ex = expf(fmaf(dx, fmaf(ah, dx, bh * dy), (ch * dy) * dy));
      const float w = op * ex;
      const float4 q0 = gs[l * 2 + 0], q1 = gs[l * 2 + 1];
      const float g[FEAT] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float gw = 0.f;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gw = fmaf(g[f], fe[f], gw);
      const float ge = w * gw;
      top = fmaf(ex, gw, top);
      const float u = ge * dx;
      const float v = ge * dy;
      tdx += u;
      tdy += v;
      txx = fmaf(u, dx, txx);
      txy = fmaf(u, dy, txy);
      tyy = fmaf(v, dy, tyy);
#pragma unroll
      for (int f = 0; f < FEAT; ++f) tf[f] = fmaf(g[f], w, tf[f]);
    }
    mdx += tdx;
    mdy += tdy;
    mxx += txx;
    mxy += txy;
    myy += tyy;
    sop += top;
#pragma unroll
    for (int f = 0; f < FEAT; ++f) gf[f] += tf[f];
  }

  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(gi) * GD);
  dst[0] = make_float4(fmaf(a, mdx, b * mdy), fmaf(b, mdx, c * mdy),
                       -0.5f * mxx, -mxy);
  dst[1] = make_float4(-0.5f * myy, sop, gf[0], gf[1]);
  dst[2] = make_float4(gf[2], gf[3], gf[4], gf[5]);
  dst[3] = make_float4(gf[6], gf[7], 0.f, 0.f);
}

}  // namespace

extern "C" cudaError_t splat_v1_bwd_launch(const unsigned char* mask,
                                           const float* gdata,
                                           const float* g8, float* out,
                                           int n_tiles, int n_blocks,
                                           int width, int nb, int tp,
                                           cudaStream_t stream) {
  if (n_tiles <= 0 || n_blocks <= 0 || width <= 0 || nb <= 0 || nb % KG
      || tp <= 0 || tp % 128 || tp > TP_MAX)
    return cudaErrorInvalidValue;
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      splat_v1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_MAX));
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(tp) * FEAT * sizeof(float);
  splat_v1_bwd_kernel<<<n_blocks * nb / KG, KG, smem, stream>>>(
      mask, gdata, g8, out, n_tiles, n_blocks, width, nb, tp);
  return cudaGetLastError();
}

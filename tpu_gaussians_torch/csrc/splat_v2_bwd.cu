// General-conic (EWA) band accumulation, backward (K6).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_bwd_kernel_v2,
// launched there by _bwd_call_v2. Given the cotangent g8 (8, n_bands*2048) of
// K5's output (splat_v2_fwd.cu), for each band i (pixels i*2048 ... of the
// row-major frame, centres at +0.5) and each gaussian of its block range
// [lo[i], lo[i] + cnt[i]) of nb gaussians, with the conic pre-scaled as in
// K5 (a' = -a/2, b' = -b, c' = -c/2) and featsop = feats * op:
//
//   x    = exp(dx (a' dx + b' dy) + c' dy^2)
//   g_x  = sum_f g8[f, p] featsop_f,   g_e = x g_x
//   Mdx = sum g_e dx, Mdy = sum g_e dy, Mxx = sum g_e dx^2,
//   Mxy = sum g_e dx dy, Myy = sum g_e dy^2,   g_featop_f = sum_p g8[f, p] x
//
// summed over every band whose range holds the gaussian, and writes its row
// [Mdx, Mdy, Mxx, Mxy, Myy, 0, g_featop(8), 0, 0] of out (n_pad, 16). Rows of
// blocks that no band reaches are zero. A row of zero opacity (padding, dead
// capacity) has featsop 0, so its moments are 0; its g_featop is the true
// derivative, as on the TPU (the post-pass multiplies it by op).
//
// Design. The TPU adds each band's contribution into a resident out across a
// band grid that runs in order; CUDA blocks run concurrently and in no order.
// So the kernel is gaussian-major and deterministic, without atomics, as K2
// (splat_sep_bwd.cu): a block of 128 threads owns 128 gaussians of one
// nb-block (a thread per gaussian) and walks, in band order, the bands whose
// range holds that block. To fill the card at a few thousand gaussians, each
// band's 2048 pixels are split over blockIdx.y into SPLIT segments of 256: a
// block stages its segment of g8 (256 pixels x 8 floats, 8 KB) in shared
// memory, every thread reads it by broadcast, and the 13 sums stay in
// registers. The segments' partial rows go to a scratch array, and a second
// kernel adds them in segment order, so two launches give the same bits.
// f32 throughout, fmaf and expf (no fast math), nothing cut off.
//
// Bound: f32 ALU work, 52 flops (a multiply-add counted as 2) and one exp per
// (gaussian, pixel) pair of the ranges: dx, dy, the Horner exponent (7),
// g_x (8 multiply-adds), g_e, u = g_e dx and v = g_e dy, the five moment
// sums (8) and g_featop (8 multiply-adds); against 64 B read per gaussian,
// the band's g8 (32 B per pixel) read once and 64 B written per gaussian.
// Operations bound it by far.
//
// Inputs: lo, cnt (n_bands,) int32; gdata (n_pad, 16) f32 rows [px, py, a',
// b', c', op, featsop(8), 0, 0], n_pad a multiple of nb, nb of 128; g8
// (8, n_bands*2048) f32; part (SPLIT, n_pad, 16) f32 scratch. Build: nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler
// -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int TP2 = 2048;          // pixels per band
constexpr int GD = 16;             // floats per gaussian row
constexpr int FEAT = 8;            // cotangent rows
constexpr int KG = 128;            // gaussians (threads) per block; nb % KG == 0
constexpr int SPLIT = 8;           // pixel segments per band (blockIdx.y)
constexpr int SEG = TP2 / SPLIT;   // pixels per segment
constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(KG)
splat_v2_bwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                    const float* __restrict__ gdata,
                    const float* __restrict__ g8, float* __restrict__ part,
                    int n_bands, int width, int nb, int n_pad) {
  __shared__ float4 gs[SEG * FEAT / 4];     // 8 KB: [pixel][f] of the segment
  float* gsf = reinterpret_cast<float*>(gs);

  const int gi = blockIdx.x * KG + threadIdx.x;
  const int blk = blockIdx.x * KG / nb;     // the nb-block of all 128
  const int seg = blockIdx.y;
  const size_t hw_pad = static_cast<size_t>(n_bands) * TP2;
  const float4* row = reinterpret_cast<const float4*>(gdata + static_cast<size_t>(gi) * GD);
  const float4 h0 = row[0], h1 = row[1], h2 = row[2], h3 = row[3];
  const float px = h0.x, py = h0.y, a = h0.z, b = h0.w, c = h1.x;
  const float fo[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};

  float mdx = 0.f, mdy = 0.f, mxx = 0.f, mxy = 0.f, myy = 0.f;
  float gf[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) gf[f] = 0.f;

  for (int band = 0; band < n_bands; ++band) {
    const int l = lo[band];
    if (blk < l || blk >= l + cnt[band]) continue;   // uniform in the block
    const int p0 = band * TP2 + seg * SEG;
    __syncthreads();   // the previous segment's reads are over
    for (int k = threadIdx.x; k < SEG * FEAT; k += KG) {
      const int f = k / SEG, j = k % SEG;
      gsf[j * FEAT + f] = g8[f * hw_pad + p0 + j];
    }
    __syncthreads();
    int col = p0 % width, rw = p0 / width;
    for (int j = 0; j < SEG; ++j) {
      const float dx = (static_cast<float>(col) + 0.5f) - px;
      const float dy = (static_cast<float>(rw) + 0.5f) - py;
      if (++col == width) { col = 0; ++rw; }
      const float x = expf(dx * fmaf(a, dx, b * dy) + (c * dy) * dy);
      const float4 q0 = gs[j * 2 + 0], q1 = gs[j * 2 + 1];
      const float g[FEAT] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float gx = 0.f;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gx = fmaf(g[f], fo[f], gx);
      const float ge = x * gx;
      const float u = ge * dx, v = ge * dy;
      mdx += u;
      mdy += v;
      mxx = fmaf(u, dx, mxx);
      mxy = fmaf(u, dy, mxy);
      myy = fmaf(v, dy, myy);
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gf[f] = fmaf(g[f], x, gf[f]);
    }
  }

  float4* o = reinterpret_cast<float4*>(
      part + (static_cast<size_t>(seg) * n_pad + gi) * GD);
  o[0] = make_float4(mdx, mdy, mxx, mxy);
  o[1] = make_float4(myy, 0.f, gf[0], gf[1]);
  o[2] = make_float4(gf[2], gf[3], gf[4], gf[5]);
  o[3] = make_float4(gf[6], gf[7], 0.f, 0.f);
}

// out[i] = sum over segments s = 0 .. SPLIT-1, in that order, of part[s][i]
// (one float4 of a row per thread).
__global__ void __launch_bounds__(RED_THREADS)
segment_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                   int n4) {
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
#pragma unroll
  for (int k = 1; k < SPLIT; ++k) {
    const float4 p = part[static_cast<size_t>(k) * n4 + i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  out[i] = s;
}

}  // namespace

extern "C" int splat_v2_bwd_split() { return SPLIT; }

extern "C" cudaError_t splat_v2_bwd_launch(const int* lo, const int* cnt,
                                           const float* gdata, const float* g8,
                                           float* part, float* out,
                                           int n_bands, int width, int nb,
                                           int n_pad, cudaStream_t stream) {
  if (n_bands <= 0 || width <= 0 || nb % KG || n_pad % nb || n_pad <= 0)
    return cudaErrorInvalidValue;
  splat_v2_bwd_kernel<<<dim3(n_pad / KG, SPLIT), KG, 0, stream>>>(
      lo, cnt, gdata, g8, part, n_bands, width, nb, n_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n4 = n_pad * (GD / 4);
  segment_sum_kernel<<<(n4 + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0,
                       stream>>>(reinterpret_cast<const float4*>(part),
                                 reinterpret_cast<float4*>(out), n4);
  return cudaGetLastError();
}

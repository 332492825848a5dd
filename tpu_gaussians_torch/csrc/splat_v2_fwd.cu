// General-conic (EWA) band accumulation, forward.
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_fwd_kernel_v2,
// launched there by _fwd_call_v2. Per 2048-pixel band i of the row-major
// frame (pixels i*2048 ... ; centres at +0.5), over the gaussian blocks
// [lo[i], lo[i] + cnt[i]) of nb gaussians:
//
//   e = dx (a' dx + b' dy) + c' dy^2        (conic pre-scaled: a' = -a/2, ...)
//   acc[f, p] += featsop_f * exp(e)          (featsop = feats * op)
//
// and writes acc (8, n_bands*2048). No cutoff: a band's range holds every
// block whose conservative y-extent (weight >= 1e-14) reaches it.
//
// Bound: f32 ALU and SFU work, 25 operations and one exp per (gaussian, pixel)
// pair of the ranges, against 64 B read per gaussian and 32 B written per
// pixel. Design: one thread per pixel, 8 blocks of 256 threads per band; each
// block streams its band's gaussian rows through shared memory 128 at a time,
// every thread reading them by broadcast, with its 8 sums in registers. The
// TPU's matrix product featsop . exp(e) is 8 FFMAs per pair here.
//
// Inputs: lo, cnt (n_bands,) int32; gdata (n_pad, 16) f32 rows [px, py, a',
// b', c', op, featsop(8), 0, 0], n_pad a multiple of nb, nb of 128. Build:
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int TP2 = 2048;        // pixels per band
constexpr int THREADS = 256;     // pixels per block
constexpr int BLOCKS_PER_BAND = TP2 / THREADS;
constexpr int GD = 16;           // floats per gaussian row
constexpr int FEAT = 8;          // output rows
constexpr int CHUNK = 128;       // gaussian rows staged at a time; nb % CHUNK == 0

__global__ void __launch_bounds__(THREADS)
splat_v2_fwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                    const float* __restrict__ gdata, float* __restrict__ out,
                    int width, int nb, int hw_pad) {
  __shared__ float4 rows[CHUNK * GD / 4];    // 8 KB

  const int band = blockIdx.x / BLOCKS_PER_BAND;
  const int p = band * TP2 + (blockIdx.x % BLOCKS_PER_BAND) * THREADS
                + threadIdx.x;
  const float gx = static_cast<float>(p % width) + 0.5f;
  const float gy = static_cast<float>(p / width) + 0.5f;

  float acc[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) acc[f] = 0.f;

  const int g0 = lo[band] * nb;
  const int g1 = g0 + cnt[band] * nb;
  const float4* src = reinterpret_cast<const float4*>(gdata);
  for (int base = g0; base < g1; base += CHUNK) {
    __syncthreads();   // the previous chunk's reads are over
    for (int k = threadIdx.x; k < CHUNK * (GD / 4); k += THREADS)
      rows[k] = src[static_cast<size_t>(base) * (GD / 4) + k];
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < CHUNK; ++s) {
      const float4 h0 = rows[s * 4 + 0];    // px, py, a', b'
      const float4 h1 = rows[s * 4 + 1];    // c', op, featsop 0, 1
      const float4 h2 = rows[s * 4 + 2];    // featsop 2..5
      const float4 h3 = rows[s * 4 + 3];    // featsop 6, 7, 0, 0
      const float dx = gx - h0.x;
      const float dy = gy - h0.y;
      const float x = expf(dx * (h0.z * dx + h0.w * dy) + (h1.x * dy) * dy);
      acc[0] += h1.z * x;
      acc[1] += h1.w * x;
      acc[2] += h2.x * x;
      acc[3] += h2.y * x;
      acc[4] += h2.z * x;
      acc[5] += h2.w * x;
      acc[6] += h3.x * x;
      acc[7] += h3.y * x;
    }
  }
#pragma unroll
  for (int f = 0; f < FEAT; ++f)
    out[static_cast<size_t>(f) * hw_pad + p] = acc[f];
}

}  // namespace

extern "C" cudaError_t splat_v2_fwd_launch(const int* lo, const int* cnt,
                                           const float* gdata, float* out,
                                           int n_bands, int width, int nb,
                                           cudaStream_t stream) {
  if (n_bands <= 0) return cudaSuccess;
  splat_v2_fwd_kernel<<<n_bands * BLOCKS_PER_BAND, THREADS, 0, stream>>>(
      lo, cnt, gdata, out, width, nb, n_bands * TP2);
  return cudaGetLastError();
}

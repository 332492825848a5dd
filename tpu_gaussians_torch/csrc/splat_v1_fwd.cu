// General-conic accumulation over a (pixel tile x gaussian block) grid,
// forward (K9a).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_fwd_kernel,
// launched there by _fwd_call: the dense EWA route above the sizes at which
// the band kernels' gaussian data (K5, splat_v2_fwd.cu) fit the TPU's VMEM.
// Per tile i of tp pixels of the row-major frame (pixels i*tp ..., centres at
// +0.5) and per block j of nb gaussians with mask[i, j] set, in block order:
//
//   e = -0.5 (a dx^2 + 2 b dx dy + c dy^2)      (the conic unscaled)
//   acc[f, p] += feats_f * op * exp(e)            (feats not pre-multiplied)
//
// and writes acc (8, n_tiles*tp). No cutoff: the mask holds every block whose
// conservative y-extent (weight >= 1e-14) reaches the tile. The TPU kernel
// skips a (tile, block) grid step whose mask bit is clear; so does this one,
// on the same mask, unpacked (one byte per pair).
//
// Bound: f32 ALU work, 26 flops (a multiply-add counted as 2) and one exp per
// (gaussian, pixel) pair of the active (tile, block) pairs: dx, dy, the
// exponent in Horner form on per-row coefficients (7), op * exp and 8
// multiply-adds; against 64 B read per gaussian, the mask read once and 32 B
// written per pixel. Operations bound it.
//
// Design. One thread per pixel, tp / 128 blocks of 128 threads per tile, so
// that a 512x512 frame (128 tiles of 2048) gives 2048 blocks. A block walks
// its tile's mask row in block order; for each active block it stages the
// gaussian rows 128 at a time in shared memory, turning the conic into the
// Horner coefficients -a/2, -b, -c/2 on the way, and every thread reads them
// by broadcast, its sums in registers. A pixel of a 1M-gaussian scene sums
// some 10^5 terms, so it sums in two levels: each block's 8 partial sums
// over its rows in order, then the partials in block order. That keeps the
// f32 rounding near sqrt(nb) + sqrt(blocks) units rather than
// sqrt(terms), and two launches give the same bits. f32 throughout, expf
// (no fast math).
//
// Inputs: mask (n_tiles, n_blocks) uint8; gdata (n_blocks*nb, 16) f32 rows
// [px, py, a, b, c, op, feats(8), 0, 0]; nb and tp multiples of 128, tp at
// most 2048. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;     // pixels per block; tp % THREADS == 0
constexpr int GD = 16;           // floats per gaussian row
constexpr int FEAT = 8;          // output rows
constexpr int CHUNK = 128;       // gaussian rows staged at a time; nb % CHUNK == 0

__global__ void __launch_bounds__(THREADS)
splat_v1_fwd_kernel(const unsigned char* __restrict__ mask,
                    const float* __restrict__ gdata, float* __restrict__ out,
                    int n_blocks, int width, int nb, int tp, int hw_pad) {
  __shared__ float4 rows[CHUNK * GD / 4];    // 8 KB

  const int per_tile = tp / THREADS;
  const int tile = blockIdx.x / per_tile;
  const int p = tile * tp + (blockIdx.x % per_tile) * THREADS + threadIdx.x;
  const float gx = static_cast<float>(p % width) + 0.5f;
  const float gy = static_cast<float>(p / width) + 0.5f;

  float acc[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) acc[f] = 0.f;

  const unsigned char* mrow = mask + static_cast<size_t>(tile) * n_blocks;
  const float4* src = reinterpret_cast<const float4*>(gdata);
  for (int j = 0; j < n_blocks; ++j) {
    if (!mrow[j]) continue;                  // uniform in the block
    float part[FEAT];
#pragma unroll
    for (int f = 0; f < FEAT; ++f) part[f] = 0.f;
    for (int base = j * nb; base < (j + 1) * nb; base += CHUNK) {
      __syncthreads();   // the previous rows' reads are over
      for (int k = threadIdx.x; k < CHUNK; k += THREADS) {
        const size_t g = static_cast<size_t>(base + k) * (GD / 4);
        const float4 h0 = src[g], h1 = src[g + 1];
        rows[k * 4 + 0] = make_float4(h0.x, h0.y, -0.5f * h0.z, -h0.w);
        rows[k * 4 + 1] = make_float4(-0.5f * h1.x, h1.y, h1.z, h1.w);
        rows[k * 4 + 2] = src[g + 2];
        rows[k * 4 + 3] = src[g + 3];
      }
      __syncthreads();
#pragma unroll 8
      for (int s = 0; s < CHUNK; ++s) {
        const float4 h0 = rows[s * 4 + 0];   // px, py, -a/2, -b
        const float4 h1 = rows[s * 4 + 1];   // -c/2, op, f0, f1
        const float4 h2 = rows[s * 4 + 2];   // f2 .. f5
        const float4 h3 = rows[s * 4 + 3];   // f6, f7, 0, 0
        const float dx = gx - h0.x;
        const float dy = gy - h0.y;
        const float w = h1.y * expf(fmaf(dx, fmaf(h0.z, dx, h0.w * dy),
                                         (h1.x * dy) * dy));
        part[0] = fmaf(h1.z, w, part[0]);
        part[1] = fmaf(h1.w, w, part[1]);
        part[2] = fmaf(h2.x, w, part[2]);
        part[3] = fmaf(h2.y, w, part[3]);
        part[4] = fmaf(h2.z, w, part[4]);
        part[5] = fmaf(h2.w, w, part[5]);
        part[6] = fmaf(h3.x, w, part[6]);
        part[7] = fmaf(h3.y, w, part[7]);
      }
    }
#pragma unroll
    for (int f = 0; f < FEAT; ++f) acc[f] += part[f];
  }
#pragma unroll
  for (int f = 0; f < FEAT; ++f)
    out[static_cast<size_t>(f) * hw_pad + p] = acc[f];
}

}  // namespace

extern "C" cudaError_t splat_v1_fwd_launch(const unsigned char* mask,
                                           const float* gdata, float* out,
                                           int n_tiles, int n_blocks,
                                           int width, int nb, int tp,
                                           cudaStream_t stream) {
  if (n_tiles <= 0 || n_blocks <= 0 || width <= 0 || nb <= 0
      || nb % CHUNK || tp <= 0 || tp % THREADS || tp > 2048)
    return cudaErrorInvalidValue;
  splat_v1_fwd_kernel<<<n_tiles * (tp / THREADS), THREADS, 0, stream>>>(
      mask, gdata, out, n_blocks, width, nb, tp, n_tiles * tp);
  return cudaGetLastError();
}

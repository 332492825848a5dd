// Separable band accumulation for the axis footprint, forward (K1).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_fwd_kernel_sep
// (with _sep_factors and _sep_coords), launched there by _fwd_call_sep. For
// each band i of R image rows and each gaussian g of the blocks
// [lo[i], lo[i] + cnt[i]) * nb of gdata (y-sorted, so the range is
// contiguous), with pixel centres at +0.5:
//
//   Ex[c] = exp(a' (x_c - px)^2),  Ey[r] = exp(c' (y_r - py)^2)
//   acc[i, f, r, c] += (featsop_f * Ey[r]) * Ex[c]      f < 5: r, g, b, 1, z
//
// Inputs: lo, cnt (n_bands,) int32; gdata (n_pad, 16) f32 row-major rows
// [px, py, a', b', c', op, featsop(8), 0, 0] with a' = -a/2, c' = -c/2.
// Output acc (n_bands, 5, R, Wp) f32, every element written.
//
// Design: one block of 128 threads per (band, 32-row sub-band, 32-column
// strip); lane = column, warp = a group of 8 rows, so each thread keeps
// 5 x 8 sums in registers. The band's gaussians stream through shared memory
// 32 at a time: their rows, the Ex table (32 gaussians x 32 columns) and the
// factor G = featsop (x) Ey (32 gaussians x 5 x 32 rows), so one expf per
// (gaussian, column) and one per (gaussian, row) serve the whole block. The
// inner step is 40 FMAs per gaussian per thread against one Ex load and ten
// broadcast float4 loads of G. Products in true f32 (fmaf, expf; no fast
// math), the TPU's products G * Ex summed in gaussian order.
//
// Bound: about 2 * 5 * R * Wp f32 operations (one FMA per feature, row and
// column) plus R + Wp exps per evaluated (gaussian, band), against 64 B of
// gdata read per evaluated gaussian and 5 * R * Wp * 4 B written per band:
// the operations bound it by far at every shape of the training path. Left
// for later: splitting a band's gaussian range over blocks (the small frames
// of the flagship fit fill only 16 blocks), tensor-core 3xTF32 products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int GD = 16;                    // floats per gaussian row
constexpr int FEAT = 5;                   // output planes
constexpr int SUB = 32;                   // image rows per block
constexpr int COLS = 32;                  // columns per block, one per lane
constexpr int RPT = 8;                    // rows per thread
constexpr int THREADS = COLS * SUB / RPT; // 128
constexpr int KC = 32;                    // gaussians staged per chunk

__global__ void __launch_bounds__(THREADS)
splat_sep_fwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                     const float* __restrict__ gdata, float* __restrict__ out,
                     int rows, int wp, int nb, int n_pad) {
  __shared__ float4 gd_s[KC * GD / 4];                 // 2 KB: rows
  __shared__ float ex_s[KC][COLS];                     // 4 KB: Ex
  __shared__ __align__(16) float g_s[KC][FEAT * SUB];  // 20 KB: G

  const int subs = rows / SUB;
  const int band = blockIdx.x / subs;
  const int row0 = band * rows + (blockIdx.x % subs) * SUB;  // image row
  const int col0 = blockIdx.y * COLS;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int rg = tid / 32;                  // this thread's rows rg*8 .. +8

  float acc[FEAT][RPT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f)
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[f][i] = 0.f;

  const int start = lo[band] * nb;
  const int end = min((lo[band] + cnt[band]) * nb, n_pad);
  const float* gd = reinterpret_cast<const float*>(gd_s);
  for (int base = start; base < end; base += KC) {
    const int m = min(KC, end - base);
    __syncthreads();   // the previous chunk's reads are done
    const float4* src = reinterpret_cast<const float4*>(gdata) +
                        static_cast<size_t>(base) * (GD / 4);
    for (int k = tid; k < m * (GD / 4); k += THREADS) gd_s[k] = src[k];
    __syncthreads();
    for (int idx = tid; idx < m * COLS; idx += THREADS) {
      const int k = idx / COLS, c = idx % COLS;
      const float tx = (static_cast<float>(col0 + c) + 0.5f) - gd[k * GD];
      ex_s[k][c] = expf(gd[k * GD + 2] * (tx * tx));
    }
    for (int idx = tid; idx < m * SUB; idx += THREADS) {
      const int k = idx / SUB, r = idx % SUB;
      const float ty = (static_cast<float>(row0 + r) + 0.5f) - gd[k * GD + 1];
      const float ey = expf(gd[k * GD + 4] * (ty * ty));
#pragma unroll
      for (int f = 0; f < FEAT; ++f) g_s[k][f * SUB + r] = gd[k * GD + 6 + f] * ey;
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float ex = ex_s[k][lane];
#pragma unroll
      for (int f = 0; f < FEAT; ++f) {
        const float4 a = *reinterpret_cast<const float4*>(&g_s[k][f * SUB + rg * RPT]);
        const float4 b = *reinterpret_cast<const float4*>(&g_s[k][f * SUB + rg * RPT + 4]);
        acc[f][0] = fmaf(a.x, ex, acc[f][0]);
        acc[f][1] = fmaf(a.y, ex, acc[f][1]);
        acc[f][2] = fmaf(a.z, ex, acc[f][2]);
        acc[f][3] = fmaf(a.w, ex, acc[f][3]);
        acc[f][4] = fmaf(b.x, ex, acc[f][4]);
        acc[f][5] = fmaf(b.y, ex, acc[f][5]);
        acc[f][6] = fmaf(b.z, ex, acc[f][6]);
        acc[f][7] = fmaf(b.w, ex, acc[f][7]);
      }
    }
  }

  const int r0 = row0 - band * rows + rg * RPT;   // row within the band
#pragma unroll
  for (int f = 0; f < FEAT; ++f)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      out[((static_cast<size_t>(band) * FEAT + f) * rows + r0 + i) * wp + col0 + lane] =
          acc[f][i];
}

}  // namespace

extern "C" cudaError_t splat_sep_fwd_launch(const int* lo, const int* cnt,
                                            const float* gdata, float* out,
                                            int n_bands, int rows, int wp,
                                            int nb, int n_pad,
                                            cudaStream_t stream) {
  if (rows % SUB || wp % COLS || nb % KC || n_bands <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid(n_bands * (rows / SUB), wp / COLS);
  splat_sep_fwd_kernel<<<grid, THREADS, 0, stream>>>(lo, cnt, gdata, out,
                                                     rows, wp, nb, n_pad);
  return cudaGetLastError();
}

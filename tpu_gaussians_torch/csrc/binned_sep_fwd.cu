// Tile-binned separable (axis footprint) accumulation, forward (K7a).
//
// Replaces the TPU kernel
// tpu_gaussians/ops/pallas/binned.py:_binned_fwd_kernel_sep (factors
// _sep_tile_factors), launched there by _binned_call via
// _binned_fwd_call(sep=True). Conic b is 0 by the axis contract, so a slot's
// weight factorises over the 16x128-pixel tile t (centres at +0.5):
//
//   Ex[c] = exp(-a/2 (x_c - px)^2),  Ey[r] = exp(-c/2 (y_r - py)^2)
//   acc[f, (r, c)] += featsop_f * Ey[r] * Ex[c]      (featsop = feats * op)
//
// over the 512-slot chunks j of the tile's slot list with j * 512 < cnt[t]
// (later chunks are skipped, as on the TPU), and writes acc
// (8, n_tiles*2048), pixel l of tile t at column t*2048 + l (l = r*128 + c):
// the layout of K8a (binned_fwd.cu). Slots past cnt inside a processed chunk
// are the dead row (op 0) and add exact zeros. Row 3 (conic b) is not read.
//
// Design. The separable structure is the point: a slot needs 128 + 16 exps
// per tile, not 2048. One block of 512 threads per tile. The slots go through
// shared memory 128 at a time as factors, Ex (128 slots x 128 columns, 64 KB),
// Ey (128 x 16) and featsop (128 x 8), all exps evaluated once there. A thread
// owns one column and 4 consecutive rows: per slot it reads its Ex (a
// different bank per lane), Ey of its 4 rows and the 8 featsop by broadcast,
// and does 4 multiplies and 32 multiply-adds into its 32 sums in registers.
// Each pixel's sum runs in slot order, so two launches give the same bits.
// f32 throughout, expf (no fast math), no clamp.
//
// Bound: f32 ALU work, 16 flops (a multiply-add counted as 2) per (slot,
// pixel) pair of the processed chunks, counted from the function: acc +=
// G2[f, r] Ex[c], one multiply-add per feature, with G2 = featsop (x) Ey
// formed per slot and row. This loop does 17 (it forms Ey * Ex per pixel).
// The 144 exps per slot and tile are not counted. Against 64 B read per
// slot and 32 B written per pixel, operations bound it.
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
constexpr int RPT = TH * TWC / THREADS;  // rows per thread (4)
constexpr int SB = 128;          // slots staged at a time
constexpr size_t SMEM = (SB * TWC + SB * TH + SB * FEAT) * sizeof(float);

__global__ void __launch_bounds__(THREADS)
binned_sep_fwd_kernel(const float* __restrict__ gdense,
                      const int* __restrict__ cnt, float* __restrict__ out,
                      int tiles_x, int n_tiles, int cap) {
  extern __shared__ float4 smem[];
  float* ex = reinterpret_cast<float*>(smem);   // [slot][column]
  float* ey = ex + SB * TWC;                     // [slot][row]
  float* fo = ey + SB * TH;                      // [slot][feature]

  const int tile = blockIdx.x;
  const int col = threadIdx.x % TWC;
  const int grp = threadIdx.x / TWC;             // rows RPT*grp ...
  const int x0 = (tile % tiles_x) * TWC;
  const int y0 = (tile / tiles_x) * TH;

  float acc[RPT][FEAT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int f = 0; f < FEAT; ++f) acc[i][f] = 0.f;

  // Whole chunks below cnt, as the TPU grid.
  const int n_slots = min(((min(cnt[tile], cap) + NBS - 1) / NBS) * NBS, cap);
  const float* src = gdense + static_cast<size_t>(tile) * cap * GD;
  for (int base = 0; base < n_slots; base += SB) {
    __syncthreads();   // the previous factors' reads are over
    const float* rows = src + static_cast<size_t>(base) * GD;
    for (int k = threadIdx.x; k < SB * TWC; k += THREADS) {
      const float* row = rows + (k / TWC) * GD;
      const float tx = (static_cast<float>(x0 + k % TWC) + 0.5f) - row[0];
      ex[k] = expf((-0.5f * row[2]) * (tx * tx));
    }
    for (int k = threadIdx.x; k < SB * TH; k += THREADS) {
      const float* row = rows + (k / TH) * GD;
      const float ty = (static_cast<float>(y0 + k % TH) + 0.5f) - row[1];
      ey[k] = expf((-0.5f * row[4]) * (ty * ty));
    }
    for (int k = threadIdx.x; k < SB * FEAT; k += THREADS) {
      const float* row = rows + (k / FEAT) * GD;
      fo[k] = row[6 + k % FEAT] * row[5];
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < SB; ++s) {
      const float e = ex[s * TWC + col];
      const float4 y4 = reinterpret_cast<const float4*>(ey + s * TH)[grp];
      const float4 f0 = reinterpret_cast<const float4*>(fo + s * FEAT)[0];
      const float4 f1 = reinterpret_cast<const float4*>(fo + s * FEAT)[1];
      const float fv[FEAT] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
      const float yv[RPT] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float w = yv[i] * e;
#pragma unroll
        for (int f = 0; f < FEAT; ++f) acc[i][f] = fmaf(fv[f], w, acc[i][f]);
      }
    }
  }

  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  float* o = out + static_cast<size_t>(tile) * TPS + (RPT * grp) * TWC + col;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int f = 0; f < FEAT; ++f) o[f * plane + i * TWC] = acc[i][f];
}

}  // namespace

extern "C" cudaError_t binned_sep_fwd_launch(const float* gdense,
                                             const int* cnt, float* out,
                                             int tiles_x, int n_tiles,
                                             int cap, cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      binned_sep_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  binned_sep_fwd_kernel<<<n_tiles, THREADS, SMEM, stream>>>(
      gdense, cnt, out, tiles_x, n_tiles, cap);
  return cudaGetLastError();
}

// Depth-sorted front-to-back compositing over per-tile slot lists, forward.
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/sorted.py:_sorted_kernel
// (with _a_raw_sep for the axis footprint), launched there by
// _sorted_fwd_call. It computes what that kernel computes, per 16x128-pixel
// tile t, over the tile's depth-ordered slot list (nearest first):
//
//   a_raw = op * exp(-0.5 (a dx^2 + 2 b dx dy + c dy^2))     (pixel centres +0.5)
//         = (op * exp(-0.5 c dy^2)) * exp(-0.5 a dx^2)      (axis footprint, b == 0,
//                                                            the factorised form)
//   a_s   = a_raw < 1e-5 ? 0 : min(a_raw, 0.9999)
//   rgb  += T a_s f_rgb,  zsum += T a_s z,  T *= 1 - a_s
//
// and writes rows [r, g, b, 1 - T, zsum, 0, 0, 0] of out (8, n_tiles*2048).
// Early exit as on the TPU, so that both agree: before each 512-slot chunk
// the whole tile tests max T > exit_t, and stops when no pixel is above it.
// Never per pixel. chunks_done[t] counts the chunks the tile composited.
//
// Bound: f32 ALU and SFU work, about 16 flops and one exp per (slot, pixel)
// evaluated, against 64 B read per slot and 32 B written per pixel; at the
// serving shapes the operations bound it by an order of magnitude over the
// bytes. Design: one block per tile, 256 threads that each own 8 pixels of
// one column (so the x factor exp(-0.5 a dx^2) is one exp per thread and
// slot), and the tile's list streamed through a 512-row shared-memory chunk
// that every thread reads by broadcast. The separable Ex/Ey tables, warp
// culling and idle-pixel work are left for later.
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows
//   [px, py, conic_a, conic_b, conic_c, op, r, g, b, 1, z, 0, 0, 0, 0, 0];
// cnt (n_tiles,) int32 list lengths (<= cap). Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 16;           // tile height (rows)
constexpr int TWC = 128;         // tile width (columns)
constexpr int TPS = TH * TWC;    // pixels per tile
constexpr int NBS = 512;         // slots per chunk
constexpr int GD = 16;           // floats per slot row
constexpr int THREADS = 256;
constexpr int PPT = TPS / THREADS;   // pixels per thread (8)
constexpr float ALPHA_CUTOFF = 1e-5f;
constexpr float A_MAX = 0.9999f;

template <bool AXIS>
__global__ void __launch_bounds__(THREADS)
sorted_fwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt,
                  float* __restrict__ out,
                  int* __restrict__ chunks_done,
                  int tiles_x, int n_tiles, int cap, float exit_t) {
  __shared__ float4 chunk[NBS * GD / 4];     // 32 KB: one chunk of rows

  const int tile = blockIdx.x;
  const int col = threadIdx.x % TWC;
  const int row0 = threadIdx.x / TWC;        // rows row0, row0+2, ..., +14
  const float gx = static_cast<float>((tile % tiles_x) * TWC + col) + 0.5f;
  const int gy0 = (tile / tiles_x) * TH + row0;

  float gy[PPT], T[PPT], r[PPT], g[PPT], b[PPT], zs[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    gy[i] = static_cast<float>(gy0 + 2 * i) + 0.5f;
    T[i] = 1.f; r[i] = 0.f; g[i] = 0.f; b[i] = 0.f; zs[i] = 0.f;
  }

  const int n_slots = min(cnt[tile], cap);
  const float4* src = reinterpret_cast<const float4*>(
      gdense + static_cast<size_t>(tile) * cap * GD);
  int chunks = 0;
  for (int base = 0; base < n_slots; base += NBS) {
    bool live = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) live |= T[i] > exit_t;
    // Whole-tile exit test; also the barrier that ends the previous
    // chunk's reads of shared memory before it is overwritten.
    if (!__syncthreads_or(live)) break;
    const int m = min(NBS, n_slots - base);
    for (int k = threadIdx.x; k < m * (GD / 4); k += THREADS)
      chunk[k] = src[static_cast<size_t>(base) * (GD / 4) + k];
    __syncthreads();

    for (int s = 0; s < m; ++s) {
      const float4 h0 = chunk[s * 4 + 0];    // px, py, a, b
      const float4 h1 = chunk[s * 4 + 1];    // c, op, r, g
      const float4 h2 = chunk[s * 4 + 2];    // b, 1, z, 0
      const float dx = gx - h0.x;
      const float ex = AXIS ? expf(-0.5f * h0.z * (dx * dx)) : 0.f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dy = gy[i] - h0.y;
        float a_raw;
        if (AXIS) {
          a_raw = (h1.y * expf(-0.5f * h1.x * (dy * dy))) * ex;
        } else {
          a_raw = h1.y * expf(-0.5f * (h0.z * dx * dx + 2.f * h0.w * dx * dy
                                       + h1.x * dy * dy));
        }
        const float a_s = a_raw < ALPHA_CUTOFF ? 0.f : fminf(a_raw, A_MAX);
        const float w = T[i] * a_s;
        r[i] += w * h1.z;
        g[i] += w * h1.w;
        b[i] += w * h2.x;
        zs[i] += w * h2.z;
        T[i] *= 1.f - a_s;
      }
    }
    ++chunks;
  }

  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  float* o = out + static_cast<size_t>(tile) * TPS + row0 * TWC + col;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    float* p = o + 2 * i * TWC;
    p[0] = r[i];
    p[plane] = g[i];
    p[2 * plane] = b[i];
    p[3 * plane] = 1.f - T[i];
    p[4 * plane] = zs[i];
    p[5 * plane] = 0.f;
    p[6 * plane] = 0.f;
    p[7 * plane] = 0.f;
  }
  if (threadIdx.x == 0) chunks_done[tile] = chunks;
}

}  // namespace

extern "C" cudaError_t sorted_fwd_launch(const float* gdense, const int* cnt,
                                         float* out, int* chunks_done,
                                         int tiles_x, int n_tiles, int cap,
                                         float exit_t, int axis,
                                         cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (axis) {
    sorted_fwd_kernel<true><<<n_tiles, THREADS, 0, stream>>>(
        gdense, cnt, out, chunks_done, tiles_x, n_tiles, cap, exit_t);
  } else {
    sorted_fwd_kernel<false><<<n_tiles, THREADS, 0, stream>>>(
        gdense, cnt, out, chunks_done, tiles_x, n_tiles, cap, exit_t);
  }
  return cudaGetLastError();
}

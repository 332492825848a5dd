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
// that is, per band one matrix product acc[(f, r), c] = sum_k G[(f, r), k]
// Ex[c, k] with M = 5R rows, N = Wp columns and K the band's gaussian range.
//
// Inputs: lo, cnt (n_bands,) int32; gdata (n_pad, 16) f32 row-major rows
// [px, py, a', b', c', op, featsop(8), 0, 0] with a' = -a/2, c' = -c/2,
// 16-byte aligned; R 32 or 64, Wp and nb multiples of 64 (the staging,
// ops/splat._sep_dims, gives multiples of 128). Output acc
// (n_bands, 5, R, Wp) f32, every element written; part (S, n_bands, 5, R,
// Wp) f32 scratch when S > 1 (splat_sep_fwd_slice_len says S).
//
// Bound. Per evaluated (gaussian, band) pair the function needs the
// product's 2 x 5 x R x Wp flops, which the TPU runs on its matrix unit; on
// this card they go to the tensor cores in TF32 split three ways (3 x 10 R
// Wp flops at 2048 per SM and clock), above the R + Wp exps (16 per SM and clock),
// the 5R multiplies of G = featsop x Ey (f32 rate), and far above the
// bytes (gdata read and the planes written once). The
// product decides it at both the 100k-gaussian 512x512 shape of the
// training path and the flagship's 128x128 frames (tools/ab_k1.py prints
// the terms). The splits and the slice partials below are this design's
// cost, not the function's: the bound leaves them out, and chip_smoke
// reports the partials' bytes beside it.
//
// What holds it above that bound (tools/ab_k1.py's variants of this file,
// PERF.md): generating the operands costs about a quarter of its time and
// does not overlap the products (the exps and mma.sync contend; spreading
// the next chunk's generation between this chunk's steps gained nothing),
// the two small products about a fifth, and fragment loads, splits,
// barriers, partials and the last wave of blocks the rest.
//
// Design. A block of 4 warps owns 32 rows x 64 columns of one band (so
// 5 x 32 = 160 rows of the product) and one slice of the band's gaussian
// range; the grid is (band, 32-row sub-band, 64-column strip) x slice.
//   - The product runs on the tensor cores, mma.sync.m16n8k8 in TF32: A is
//     G (16 rows r of one feature f x 8 gaussians), B is Ex (8 gaussians x
//     8 columns). Each operand is split as x = big + small, big the TF32
//     part of x (low 13 mantissa bits cleared) and small the exact
//     remainder, and big.big' + big.small' + small.big' keeps near-f32
//     accuracy (relative error about 2^-21; the TPU's bf16x3 is about
//     2^-16, which would sit on the 1e-5 check). A warp owns 16 rows x 32
//     columns of all five features: 5 x 4 mma tiles, 60 products per
//     8-gaussian step.
//   - Both operands are generated per chunk of 64 gaussians into shared
//     memory in the mma fragment order, one float4 per lane and tile:
//     Ex from true expf of the column offsets (one per (gaussian, column)),
//     G = featsop_f x Ey from one expf per (gaussian, row) and five
//     multiplies. A warp's fragment load is 512 contiguous bytes (no bank
//     conflict), and so is a generating warp's store. The split is paid at
//     the load, which halves the shared memory the operands take and move.
//   - The chunk's rows arrive by cp.async; the next chunk's copy is issued
//     once this chunk's operands are generated, so it overlaps the
//     products. Ranges and slices are multiples of the chunk (nb is a
//     multiple of 64), so every chunk is full.
//   - The eight steps of a chunk are unrolled, so that fragment loads and
//     splits are hoisted ahead of the products (9% faster than a loop).
//   - Sums in three levels, in a fixed order: each 64-gaussian chunk in the
//     mma accumulator (restarted every chunk, so the tensor core's own
//     rounding stays near f32's), the chunk partials into f32 registers in
//     chunk order, and the slices' partials, which a second kernel adds in
//     slice order. No atomics: two launches give the same bits.
//   - The slices fill the card: the slice length is fixed from what the
//     host knows (n_bands, R, Wp, n_pad), so that the grid holds about
//     TARGET_BLOCKS blocks of at least MIN_SLICE gaussians, and a block
//     whose slice lies past its band's range exits at once. The first
//     slice of every tile always writes (zeros for an empty band). With
//     one slice the block writes acc itself and no second kernel runs.
//   - 80 running sums and 80 chunk sums a thread (236 registers): two
//     blocks fit on an SM, with 60 KB of shared memory each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int GD = 16;                    // floats per gaussian row
constexpr int FEAT = 5;                   // output planes
constexpr int SUB = 32;                   // image rows per block
constexpr int COLS = 64;                  // columns per block
constexpr int NT = 4;                     // 8-column mma tiles per warp
constexpr int KC = 64;                    // gaussians per chunk
constexpr int STEPS = KC / 8;             // 8-gaussian mma steps per chunk
constexpr int MIN_SLICE = 128;            // gaussians per slice, at least
constexpr long TARGET_BLOCKS = 4096;      // blocks a launch aims at
constexpr int RED_THREADS = 256;

// A chunk as cp.async lands it, and its operands in fragment order: G for
// (step, 16-row half, feature, lane) and Ex for (step, 32-column half, pair
// of 8-column tiles, lane).
struct Stage {
  float4 raw[KC * GD / 4];                // 4 KB
  float4 a[STEPS][2][FEAT][32];           // 40 KB
  float4 b[STEPS][2][NT / 2][32];         // 16 KB
};

// x = big + small: big is x with the 13 low mantissa bits cleared (a TF32
// value: one logic instruction, where cvt.rna.tf32 takes several), small the
// exact f32 remainder (|small| < 2^-10 |x|), which the tensor core reads to
// TF32 precision.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b from three TF32 products (near-f32 accuracy), small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src));
}

// Gaussians per slice of a band's range: a multiple of KC, at least
// MIN_SLICE, such that the tiles x ceil(n_pad / slice) grid holds about
// TARGET_BLOCKS blocks.
int slice_len(int n_bands, int rows, int wp, int n_pad) {
  const long tiles = static_cast<long>(n_bands) * (rows / SUB)
                     * (wp / COLS);
  long len = (tiles * n_pad + TARGET_BLOCKS - 1) / TARGET_BLOCKS;
  len = (len + KC - 1) / KC * KC;
  return static_cast<int>(len < MIN_SLICE ? MIN_SLICE : len);
}

// The staged chunk's operands, thread slot by slot. Ex: slot
// (step, column half, tile pair, lane g*4 + t) holds Ex at columns c and
// c + 8 (c the lane's column g of the first tile) for gaussians t and t + 4
// of the step, as B's fragments (b0, b1) of the two tiles. G: slot (step,
// row half, lane) holds, per feature, A's fragment: rows g, g + 8 of the
// half for gaussians t, t + 4.
__device__ __forceinline__ void generate(Stage& S, float x0, float y0) {
  const float* raw = reinterpret_cast<const float*>(S.raw);
  for (int i = threadIdx.x; i < STEPS * 2 * (NT / 2) * 32; i += THREADS) {
    const int lane = i & 31, jp = (i >> 5) & 1, wn = (i >> 6) & 1,
              s = i >> 7;
    const int g = lane >> 2, t = lane & 3;
    const float x = x0 + static_cast<float>(wn * 32 + jp * 16 + g);
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {       // (column c or c + 8, gaussian)
      const float* row = raw + (s * 8 + t + 4 * (q & 1)) * GD;
      const float tx = (x + static_cast<float>(8 * (q >> 1))) - row[0];
      e[q] = expf(row[2] * (tx * tx));
    }
    S.b[s][wn][jp][lane] = make_float4(e[0], e[1], e[2], e[3]);
  }
  for (int i = threadIdx.x; i < STEPS * 2 * 32; i += THREADS) {
    const int lane = i & 31, wm = (i >> 5) & 1, s = i >> 6;
    const int g = lane >> 2, t = lane & 3;
    const float* r0 = raw + (s * 8 + t) * GD;       // gaussian t
    const float* r1 = r0 + 4 * GD;                  // gaussian t + 4
    const float y = y0 + static_cast<float>(wm * 16 + g);
    const float ty00 = y - r0[1], ty01 = (y + 8.f) - r0[1];
    const float ty10 = y - r1[1], ty11 = (y + 8.f) - r1[1];
    const float ey00 = expf(r0[4] * (ty00 * ty00));  // row g, gaussian t
    const float ey01 = expf(r0[4] * (ty01 * ty01));  // row g + 8
    const float ey10 = expf(r1[4] * (ty10 * ty10));  // row g, gaussian t + 4
    const float ey11 = expf(r1[4] * (ty11 * ty11));
#pragma unroll
    for (int f = 0; f < FEAT; ++f) {
      const float f0 = r0[6 + f], f1 = r1[6 + f];
      S.a[s][wm][f][lane] =
          make_float4(f0 * ey00, f0 * ey01, f1 * ey10, f1 * ey11);
    }
  }
}

// One staged chunk into d (zeroed by the caller): the warp's 16 rows (half
// wm) of every feature against its 32 columns (half wn).
__device__ __forceinline__ void chunk(const Stage& S, float (&d)[FEAT][NT][4],
                                      int wm, int wn, int lane) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      const float4 b = S.b[s][wn][jp][lane];
      split(b.x, bb[2 * jp][0], bs[2 * jp][0]);
      split(b.y, bb[2 * jp][1], bs[2 * jp][1]);
      split(b.z, bb[2 * jp + 1][0], bs[2 * jp + 1][0]);
      split(b.w, bb[2 * jp + 1][1], bs[2 * jp + 1][1]);
    }
#pragma unroll
    for (int f = 0; f < FEAT; ++f) {
      const float4 a = S.a[s][wm][f][lane];
      uint32_t ab[4], as[4];
      split(a.x, ab[0], as[0]);
      split(a.y, ab[1], as[1]);
      split(a.z, ab[2], as[2]);
      split(a.w, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(d[f][j], ab, as, bb[j][0], bb[j][1], bs[j][0], bs[j][1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
splat_sep_fwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                     const float* __restrict__ gdata, float* __restrict__ part,
                     int n_bands, int rows, int wp, int nb, int n_pad,
                     int slice) {
  extern __shared__ float4 smem[];
  Stage& S = *reinterpret_cast<Stage*>(smem);

  const int subs = rows / SUB, strips = wp / COLS;
  const int band = blockIdx.x / (subs * strips);
  const int sub = blockIdx.x / strips % subs;
  const int col0 = (blockIdx.x % strips) * COLS;
  const int band_start = lo[band] * nb;
  const int band_end = min((lo[band] + cnt[band]) * nb, n_pad);
  const int start = band_start + blockIdx.y * slice;
  if (blockIdx.y > 0 && start >= band_end) return;   // past the range
  const int end = min(start + slice, band_end);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const float x0 = static_cast<float>(col0) + 0.5f;
  const float y0 = static_cast<float>(band * rows + sub * SUB) + 0.5f;

  float acc[FEAT][NT][4];
#pragma unroll
  for (int f = 0; f < FEAT; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] = 0.f;

  // The rows [base, base + KC) (end - base is a multiple of KC).
  auto issue = [&](int base) {
    const float* src = gdata + static_cast<size_t>(base) * GD;
    for (int k = threadIdx.x; k < KC * GD / 4; k += THREADS)
      cp_async16(&S.raw[k], src + 4 * k);
  };
  if (start < end) issue(start);
  asm volatile("cp.async.commit_group;");
  for (int base = start; base < end; base += KC) {
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();   // the chunk has landed; the last chunk's math is over
    generate(S, x0, y0);
    __syncthreads();   // generated; the raw buffer is free
    if (base + KC < end) issue(base + KC);
    asm volatile("cp.async.commit_group;");
    float d[FEAT][NT][4];
#pragma unroll
    for (int f = 0; f < FEAT; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[f][j][i] = 0.f;
    chunk(S, d, wm, wn, lane);
#pragma unroll
    for (int f = 0; f < FEAT; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][j][i] += d[f][j][i];
  }

  // D's layout: (row g, column 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
  const int g = lane >> 2, t = lane & 3;
  const int r = sub * SUB + wm * 16 + g;               // row within the band
  float* out = part + (static_cast<size_t>(blockIdx.y) * n_bands + band)
                          * FEAT * rows * wp;
#pragma unroll
  for (int f = 0; f < FEAT; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = col0 + wn * 32 + j * 8 + 2 * t;
      float* p = out + (static_cast<size_t>(f) * rows + r) * wp + c;
      *reinterpret_cast<float2*>(p) = make_float2(acc[f][j][0], acc[f][j][1]);
      *reinterpret_cast<float2*>(p + 8 * wp) =
          make_float2(acc[f][j][2], acc[f][j][3]);
    }
}

// out[band] = the band's slice partials summed in slice order: slices 0 ..
// ceil(len / slice) - 1 of its range (at least slice 0), one float4 a
// thread.
__global__ void __launch_bounds__(RED_THREADS)
slice_sum_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                 const float4* __restrict__ part, float4* __restrict__ out,
                 int n_bands, int per_band4, int nb, int n_pad, int slice) {
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n_bands * per_band4) return;
  const int band = i / per_band4;
  const int len = min((lo[band] + cnt[band]) * nb, n_pad) - lo[band] * nb;
  const int live = max(1, (len + slice - 1) / slice);
  const size_t stride = static_cast<size_t>(n_bands) * per_band4;
  float4 s = part[i];
  for (int k = 1; k < live; ++k) {
    const float4 p = part[k * stride + i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  out[i] = s;
}

}  // namespace

// The slice length the launcher uses for these shapes; the scratch `part`
// holds ceil(n_pad / slice_len) slices (none is needed for one).
extern "C" int splat_sep_fwd_slice_len(int n_bands, int rows, int wp,
                                       int n_pad) {
  return slice_len(n_bands, rows, wp, n_pad);
}

extern "C" cudaError_t splat_sep_fwd_launch(const int* lo, const int* cnt,
                                            const float* gdata, float* part,
                                            float* out, int n_bands, int rows,
                                            int wp, int nb, int n_pad,
                                            cudaStream_t stream) {
  if ((rows != 32 && rows != 64) || wp <= 0 || wp % COLS || nb <= 0
      || nb % KC || n_pad <= 0 || n_pad % nb || n_bands <= 0)
    return cudaErrorInvalidValue;
  const int slice = slice_len(n_bands, rows, wp, n_pad);
  const int slices = (n_pad + slice - 1) / slice;
  const int tiles = n_bands * (rows / SUB) * (wp / COLS);
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t attr = cudaFuncSetAttribute(
      splat_sep_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Stage)));
  if (attr != cudaSuccess) return attr;
  splat_sep_fwd_kernel<<<dim3(tiles, slices), THREADS, sizeof(Stage),
                         stream>>>(
      lo, cnt, gdata, slices > 1 ? part : out, n_bands, rows, wp, nb, n_pad,
      slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const int per_band4 = FEAT * rows * wp / 4;
  const int n4 = n_bands * per_band4;
  slice_sum_kernel<<<(n4 + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0,
                     stream>>>(lo, cnt, reinterpret_cast<const float4*>(part),
                               reinterpret_cast<float4*>(out), n_bands,
                               per_band4, nb, n_pad, slice);
  return cudaGetLastError();
}

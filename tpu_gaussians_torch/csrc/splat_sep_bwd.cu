// Separable band accumulation for the axis footprint, backward (K2).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_bwd_kernel_sep,
// launched there by _bwd_call_sep. Given the cotangent gband of the forward's
// output, for each band i and each gaussian of its block range (as K1),
// with tx = x_c - px, ty = y_r - py, Ex, Ey and G[f, r] = featsop_f Ey[r]:
//
//   gG[f, r]    = sum_c gband[i, f, r, c] Ex[c]
//   g_featop_f  = sum_r gG[f, r] Ey[r]
//   gEy[r]      = sum_f gG[f, r] featsop_f
//   gEx[c]      = sum_{f,r} gband[i, f, r, c] G[f, r]
//   u_x = gEx Ex, u_y = gEy Ey
//   Mdx = sum_c u_x tx, Mxx = sum_c u_x tx^2, Mdy = sum_r u_y ty,
//   Myy = sum_r u_y ty^2
//
// and writes each gaussian's row [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop(8), 0,
// 0] of out (n_pad, 16), summed over every band whose range holds it.
// Inputs: lo, cnt, gdata as K1; gband (n_bands, 5, R, Wp) f32.
//
// Design. The TPU accumulates out in place across a band grid that runs in
// order; CUDA blocks run concurrently and in no order. So the kernel is
// gaussian-major and deterministic, without atomics: one block of 128
// threads owns 32 gaussians (lane = gaussian, warp = one of 4 groups) and
// walks the bands whose range holds its gaussians, in band order, as the
// TPU does. Per band it builds G (32 x 5R) and Ey in shared memory, then
// streams the band's gband in 32-column tiles through shared memory
// (transposed, so each thread reads float4s of it by broadcast). Per tile a
// thread computes Ex and tx for 8 of the columns, accumulates 5R/4 rows of
// gG in registers over all 32 columns, and gEx for its 8 columns, folding
// them into partial Mdx, Mxx. At the end of the band the four groups'
// partials are reduced in a fixed order by one thread per gaussian, which
// also forms g_featop, gEy, Mdy and Myy, and adds the band's sums into its
// running row; each row is written once. Results are therefore the same
// from launch to launch. f32 throughout, fmaf and expf (no fast math).
//
// Bound: about 2 * 2 * 5 * R * Wp f32 operations per evaluated (gaussian,
// band) (the gG and gEx products, a multiply-add each), twice K1's, plus
// the moments and R + Wp exps, against gband read once per evaluated band
// (5 * R * Wp * 4 B), 64 B of gdata per gaussian and 64 B written per
// gaussian: operations bound it. The block re-reads gband from L2 once per
// 32 gaussians. Left for later: tensor-core products for gG and gEx.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

namespace {

constexpr int GD = 16;          // floats per gaussian row
constexpr int FEAT = 5;         // feature planes of gband
constexpr int KG = 32;          // gaussians per block, one per lane
constexpr int CG = 4;           // thread groups (warps) per gaussian
constexpr int THREADS = KG * CG;
constexpr int CT = 32;          // columns per gband tile
constexpr int CPT = CT / CG;    // tile columns per thread in the gEx pass

template <int R>
struct Smem {
  static constexpr int FR = FEAT * R;     // rows (f, r) of G and gband
  static constexpr int LD = FR + 4;       // padded stride: float4-aligned
  static constexpr int T = 0;             // [CT][LD]  gband tile, transposed
  static constexpr int G = T + CT * LD;   // [KG][LD]  G, then gG
  static constexpr int EX = G + KG * LD;  // [CT][KG]  Ex
  static constexpr int TX = EX + CT * KG; // [CT][KG]  tx
  static constexpr int EY = TX + CT * KG; // [KG][R + 1]  Ey
  static constexpr int RED = EY + KG * (R + 1);  // [CG][KG][2] Mdx, Mxx
  static constexpr int FLOATS = RED + CG * KG * 2;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int R>
__global__ void __launch_bounds__(THREADS)
splat_sep_bwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                     const float* __restrict__ gdata,
                     const float* __restrict__ gband, float* __restrict__ out,
                     int n_bands, int wp, int nb) {
  using S = Smem<R>;
  constexpr int FR = S::FR, LD = S::LD, FRT = FR / CG;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* t_s = smem + S::T;
  float* g_s = smem + S::G;
  float* ex_s = smem + S::EX;
  float* tx_s = smem + S::TX;
  float* ey_s = smem + S::EY;
  float* red_s = smem + S::RED;

  const int k = threadIdx.x % KG;          // this thread's gaussian
  const int cg = threadIdx.x / KG;         // its group
  const int gi = blockIdx.x * KG + k;
  const int blk = blockIdx.x * KG / nb;    // the nb-block of all 32
  const float* row = gdata + static_cast<size_t>(gi) * GD;
  const float px = row[0], py = row[1], a2 = row[2], c2 = row[4];
  float fo[FEAT];
#pragma unroll
  for (int f = 0; f < FEAT; ++f) fo[f] = row[6 + f];

  // Running sums over bands (kept by the group-0 thread of each gaussian).
  float mdx = 0.f, mdy = 0.f, mxx = 0.f, myy = 0.f, gfo[FEAT] = {};

  for (int band = 0; band < n_bands; ++band) {
    const int l = lo[band];
    if (blk < l || blk >= l + cnt[band]) continue;   // uniform in the block
    __syncthreads();   // the previous band's reads of shared memory are done
    for (int r = cg; r < R; r += CG) {
      const float ty = (static_cast<float>(band * R + r) + 0.5f) - py;
      const float ey = expf(c2 * (ty * ty));
      ey_s[k * (R + 1) + r] = ey;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) g_s[k * LD + f * R + r] = fo[f] * ey;
    }

    float gg[FRT];                       // gG rows cg*FRT .. +FRT
#pragma unroll
    for (int j = 0; j < FRT; ++j) gg[j] = 0.f;
    float bdx = 0.f, bxx = 0.f;          // this group's Mdx, Mxx partials
    const float* gb = gband + static_cast<size_t>(band) * FR * wp;
    for (int col0 = 0; col0 < wp; col0 += CT) {
      __syncthreads();   // the previous tile is consumed; G is written
      for (int idx = threadIdx.x; idx < FR * CT; idx += THREADS) {
        const int fr = idx / CT, c = idx % CT;
        t_s[c * LD + fr] = gb[static_cast<size_t>(fr) * wp + col0 + c];
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = cg * CPT + q;
        const float tx = (static_cast<float>(col0 + c) + 0.5f) - px;
        ex_s[c * KG + k] = expf(a2 * (tx * tx));
        tx_s[c * KG + k] = tx;
      }
      __syncthreads();

      // gG[fr] += sum_c T[c][fr] Ex[c]   (T read by broadcast)
      for (int c = 0; c < CT; ++c) {
        const float e = ex_s[c * KG + k];
        const float4* t4 = reinterpret_cast<const float4*>(t_s + c * LD + cg * FRT);
#pragma unroll
        for (int j = 0; j < FRT / 4; ++j) {
          const float4 t = t4[j];
          gg[4 * j + 0] = fmaf(t.x, e, gg[4 * j + 0]);
          gg[4 * j + 1] = fmaf(t.y, e, gg[4 * j + 1]);
          gg[4 * j + 2] = fmaf(t.z, e, gg[4 * j + 2]);
          gg[4 * j + 3] = fmaf(t.w, e, gg[4 * j + 3]);
        }
      }
      // gEx[c] = sum_fr T[c][fr] G[fr] for this group's 8 columns
      float gex[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) gex[q] = 0.f;
      const float4* g4 = reinterpret_cast<const float4*>(g_s + k * LD);
#pragma unroll 4
      for (int j = 0; j < FR / 4; ++j) {
        const float4 g = g4[j];
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const float4 t = reinterpret_cast<const float4*>(
              t_s + (cg * CPT + q) * LD)[j];
          gex[q] = fmaf(t.x, g.x, gex[q]);
          gex[q] = fmaf(t.y, g.y, gex[q]);
          gex[q] = fmaf(t.z, g.z, gex[q]);
          gex[q] = fmaf(t.w, g.w, gex[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = cg * CPT + q;
        const float tx = tx_s[c * KG + k];
        const float t1 = (gex[q] * ex_s[c * KG + k]) * tx;
        bdx += t1;
        bxx += t1 * tx;
      }
    }

    __syncthreads();   // every read of G and the last tile is done
#pragma unroll
    for (int j = 0; j < FRT; ++j) g_s[k * LD + cg * FRT + j] = gg[j];
    red_s[(cg * KG + k) * 2 + 0] = bdx;
    red_s[(cg * KG + k) * 2 + 1] = bxx;
    __syncthreads();
    if (cg == 0) {
      float sdx = 0.f, sxx = 0.f;
#pragma unroll
      for (int q = 0; q < CG; ++q) {
        sdx += red_s[(q * KG + k) * 2 + 0];
        sxx += red_s[(q * KG + k) * 2 + 1];
      }
      float bfo[FEAT] = {}, sdy = 0.f, syy = 0.f;
      for (int r = 0; r < R; ++r) {
        const float ey = ey_s[k * (R + 1) + r];
        const float ty = (static_cast<float>(band * R + r) + 0.5f) - py;
        float gey = 0.f;
#pragma unroll
        for (int f = 0; f < FEAT; ++f) {
          const float v = g_s[k * LD + f * R + r];
          bfo[f] = fmaf(v, ey, bfo[f]);
          gey = fmaf(v, fo[f], gey);
        }
        const float t2 = (gey * ey) * ty;
        sdy += t2;
        syy += t2 * ty;
      }
      mdx += sdx;
      mxx += sxx;
      mdy += sdy;
      myy += syy;
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gfo[f] += bfo[f];
    }
  }

  if (cg == 0) {
    float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(gi) * GD);
    o[0] = make_float4(mdx, mdy, mxx, 0.f);
    o[1] = make_float4(myy, 0.f, gfo[0], gfo[1]);
    o[2] = make_float4(gfo[2], gfo[3], gfo[4], 0.f);
    o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int R>
cudaError_t launch(const int* lo, const int* cnt, const float* gdata,
                   const float* gband, float* out, int n_bands, int wp,
                   int nb, int n_pad, cudaStream_t stream) {
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      splat_sep_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<R>::BYTES));
  if (err != cudaSuccess) return err;
  splat_sep_bwd_kernel<R><<<n_pad / KG, THREADS, Smem<R>::BYTES, stream>>>(
      lo, cnt, gdata, gband, out, n_bands, wp, nb);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t splat_sep_bwd_launch(const int* lo, const int* cnt,
                                            const float* gdata,
                                            const float* gband, float* out,
                                            int n_bands, int rows, int wp,
                                            int nb, int n_pad,
                                            cudaStream_t stream) {
  if (wp % CT || nb % KG || n_pad % nb || n_bands <= 0 || n_pad <= 0)
    return cudaErrorInvalidValue;
  if (rows == 32)
    return launch<32>(lo, cnt, gdata, gband, out, n_bands, wp, nb, n_pad, stream);
  if (rows == 64)
    return launch<64>(lo, cnt, gdata, gband, out, n_bands, wp, nb, n_pad, stream);
  return cudaErrorInvalidValue;
}

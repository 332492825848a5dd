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
// and writes each gaussian's row [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop(5), 0,
// ...] of out (n_pad, 16), summed over every band whose range holds it.
// Inputs: lo, cnt, gdata as K1; gband (n_bands, 5, R, Wp) f32; R 32 or 64,
// Wp and nb multiples of 64 (the staging, ops/splat._sep_dims, gives
// multiples of 128). part (S, n_pad, 16) f32 scratch when S > 1
// (splat_sep_bwd_slices says S).
//
// Bound. Per evaluated (gaussian, band) pair the function needs the two
// products gG = gband . Ex and gEx = gband^T . G, 2 x 2 x 5 x R x Wp flops,
// which the TPU runs on its matrix unit; on this card they go to the tensor
// cores in TF32 split three ways (3 x 20 R Wp flops at 2048 per SM and
// clock), above the R + Wp exps (16 per SM and clock), the f32 work of G
// and the moments, and far above the bytes (gband and gdata read, the rows
// written once).
// The products decide it at the 100k-gaussian 512x512 shape of the training
// path and on the flagship's 128x128 frames (chip_smoke's sep_bwd_bound
// prints the terms). The splits, the re-reads of gband from L2 (once per 64
// gaussians) and the slice partials are this design's cost, not the
// function's: the bound leaves them out, and chip_smoke reports the
// partials' bytes beside it.
//
// Design. Every output is a sum over (f, r, c) of gband times factors of
// the gaussian alone, so the work splits over gaussians, over 32-row halves
// of a band and over column ranges, and the partial rows add. A block of 4
// warps owns 64 gaussians (a chunk of its nb-block), 32 rows of every band
// (sub-band; a band of 64 rows is two slices) and a range of 64-column
// strips (a slice); it walks the bands whose range holds its chunk, in band
// order, as the TPU does. The grid is chunks x slices.
//   - Both products run on the tensor cores, mma.sync.m16n8k8 in TF32, each
//     operand split as x = big + small (big the TF32 part, small the exact
//     remainder; big.big' + big.small' + small.big', relative error about
//     2^-21), K1's arithmetic:
//       P1  gG^T (64 gaussians x 160 rows) += Ex^T (64 x 64 columns) .
//           gband^T: a warp owns 8 rows r of all five features (5 n-tiles)
//           for all 64 gaussians (4 m-tiles);
//       P2  H_f^T (64 gaussians x 64 columns) = Ey^T (64 x 32 rows) .
//           gband_f, one product per feature, and gEx = sum_f featsop_f H_f
//           in f32: a warp owns 32 gaussians and four 8-column n-tiles.
//     Both read one staged gband strip: P1 with the reduction (columns)
//     along the fragment's k and P2 with it (rows) along k, so the strip is
//     stored with the 8-column groups of each 32 swizzled by the row
//     (column ^ 8 (row & 3)), which makes both reads free of bank conflicts.
//     P1's k index is permuted (k = t -> column 2t, t + 4 -> 2t + 1), so its
//     B fragment is one 8-byte load, and then P2's accumulator holds gEx at
//     the (gaussian, column) pairs of one of Ex's A fragments: the moments
//     read Ex as one float4.
//   - Ex (per strip) and Ey (per band) are formed with expf into shared
//     memory in the A fragments' order, one float4 a lane and tile; the
//     split is paid at the load.
//   - gband arrives in 64-column strips (40 KB) by cp.async, double
//     buffered: strip s + 1's copy is issued once strip s's Ex is formed, so
//     it overlaps the products.
//   - Sums in fixed orders: P1 in the mma accumulator over one strip
//     (restarted every strip, so the tensor core's own rounding stays near
//     f32's), then into f32 registers in strip order; P2 per feature (32
//     rows); Mdx and Mxx per lane over its columns, strips and bands, then
//     over the 4 lanes of a fragment row and the 2 warps of a gaussian;
//     g_featop, Mdy and Myy at each band's end from gG, over a warp's 8 rows
//     and then the 4 warps; the slices' rows by a second kernel in slice
//     order. No atomics: two launches give the same bits.
//   - The slices fill the card: from what the host knows (R, Wp, n_pad)
//     the column ranges are cut so that the grid holds at least
//     TARGET_BLOCKS blocks, one wave at two blocks an SM (the flagship's 48
//     chunks x 2 sub-bands get 2 column slices; the 100k-gaussian 512x512
//     shape's 1,563 chunks none). With one slice the block writes out
//     itself and no second kernel runs.
//   - 106 KB of shared memory and at most 255 registers a thread: two
//     blocks fit on an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int GD = 16;                    // floats per gaussian row
constexpr int FEAT = 5;                   // feature planes of gband
constexpr int SUB = 32;                   // band rows per block
constexpr int FR = FEAT * SUB;            // gband rows of a strip
constexpr int KC = 64;                    // gaussians per block
constexpr int COLS = 64;                  // columns per strip
constexpr int STEPS = COLS / 8;           // P1's 8-column steps per strip
constexpr int RSTEPS = SUB / 8;           // P2's 8-row steps per feature
constexpr int NQ = FEAT + 2;              // g_featop(5), Mdy, Myy
constexpr long TARGET_BLOCKS = 264;       // 2 blocks x 132 SMs
constexpr int RED_THREADS = 256;

struct Smem {
  float band[2][FR * COLS];               // 2 x 40 KB, swizzled strips
  float4 ex[STEPS][4][32];                // 16 KB, Ex as P1's A fragments
  float4 ey[RSTEPS][4][32];               // 8 KB, Ey as P2's A fragments
  float px[KC], py[KC], a2[KC], c2[KC], fo[FEAT][KC];
};

// The slices of a launch: column slices of strips_per_slice strips (the
// last may be shorter) times the band's 32-row halves.
struct Slicing {
  int col_slices, strips_per_slice, slices;
};

Slicing slicing(int rows, int wp, int n_pad) {
  const long base = static_cast<long>(n_pad / KC) * (rows / SUB);
  const int strips = wp / COLS;
  const long want = base >= TARGET_BLOCKS
                        ? 1 : (TARGET_BLOCKS + base - 1) / base;
  int cols = static_cast<int>(want < strips ? want : strips);
  const int per = (strips + cols - 1) / cols;
  cols = (strips + per - 1) / per;
  return {cols, per, (rows / SUB) * cols};
}

// A strip's float (row, col) in shared memory: the 8-column groups of each
// 32 columns permuted by the row, so that P1's reads (8 rows x 8 columns of
// one row pair per half warp) and P2's (4 rows x 8 columns) hit 32 banks.
__device__ __forceinline__ int swz(int row, int col) {
  return row * COLS + (col ^ ((row & 3) << 3));
}

// x = big + small: big is x with the 13 low mantissa bits cleared (a TF32
// value), small the exact f32 remainder, which the tensor core reads to
// TF32 precision (K1's split).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(float4 v, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(v.x, big[0], small[0]);
  split(v.y, big[1], small[1]);
  split(v.z, big[2], small[2]);
  split(v.w, big[3], small[3]);
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

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(THREADS, 2)
splat_sep_bwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                     const float* __restrict__ gdata,
                     const float* __restrict__ gband, float* __restrict__ dst,
                     int n_bands, int rows, int wp, int nb, int n_pad,
                     int col_slices, int per_slice) {
  extern __shared__ float4 smem[];
  Smem& S = *reinterpret_cast<Smem*>(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k_base = blockIdx.x * KC;
  const int blk = k_base / nb;
  const int sub = blockIdx.y / col_slices;
  const int strips = wp / COLS;
  const int s_begin = (blockIdx.y % col_slices) * per_slice;
  const int s_end = min(s_begin + per_slice, strips);

  if (threadIdx.x < KC) {
    const float* row = gdata + static_cast<size_t>(k_base + threadIdx.x) * GD;
    S.px[threadIdx.x] = row[0];
    S.py[threadIdx.x] = row[1];
    S.a2[threadIdx.x] = row[2];
    S.c2[threadIdx.x] = row[4];
#pragma unroll
    for (int f = 0; f < FEAT; ++f) S.fo[f][threadIdx.x] = row[6 + f];
  }

  // P2's share: gaussians 32 hw .. + 32 (m-tiles 2 hw, 2 hw + 1), columns
  // n-tiles ch, ch + 2, ch + 4, ch + 6 of each strip.
  const int hw = warp & 1, ch = warp >> 1;
  float sdx[2][2] = {}, sxx[2][2] = {};   // per (m-tile, gaussian g / g + 8)
  // P1's band sums of the gaussians of m-tile t (16 t + g, + 8): this lane
  // keeps them after the sums over the warp's rows.
  float bq[2][NQ] = {};

  for (int band = 0; band < n_bands; ++band) {
    const int l = lo[band];
    if (blk < l || blk >= l + cnt[band]) continue;   // uniform in the block
    __syncthreads();   // the chunk's rows are in; the last band's reads done
    const float y0 = static_cast<float>(band * rows + sub * SUB) + 0.5f;
    {
      // Ey for rows 8q + t, 8q + t + 4 and gaussians 16 warp + g, + 8.
      const int k0 = 16 * warp + g, k1 = k0 + 8;
      const float p0 = S.py[k0], p1 = S.py[k1], c0 = S.c2[k0], c1 = S.c2[k1];
#pragma unroll
      for (int q = 0; q < RSTEPS; ++q) {
        const float ya = y0 + static_cast<float>(8 * q + t);
        const float yb = ya + 4.f;
        const float a0 = ya - p0, a1 = ya - p1, b0 = yb - p0, b1 = yb - p1;
        S.ey[q][warp][lane] = make_float4(expf(c0 * (a0 * a0)),
                                          expf(c1 * (a1 * a1)),
                                          expf(c0 * (b0 * b0)),
                                          expf(c1 * (b1 * b1)));
      }
    }
    const float* src = gband + (static_cast<size_t>(band) * FEAT * rows
                                + sub * SUB) * wp;
    // Strip s of the band's 160 rows into buffer `buf`, 16 bytes a copy.
    auto issue = [&](int s, int buf) {
      for (int i = threadIdx.x; i < FR * COLS / 4; i += THREADS) {
        const int row = i / (COLS / 4), c = 4 * (i % (COLS / 4));
        const int f = row / SUB, r = row % SUB;
        cp_async16(&S.band[buf][swz(row, c)],
                   src + static_cast<size_t>(f * rows + r) * wp
                       + s * COLS + c);
      }
    };
    issue(s_begin, 0);
    asm volatile("cp.async.commit_group;");

    float run[FEAT][4][4];                 // gG^T: rows 8 warp + 2t (+1)
#pragma unroll
    for (int f = 0; f < FEAT; ++f)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) run[f][m][i] = 0.f;

    for (int s = s_begin; s < s_end; ++s) {
      const int buf = (s - s_begin) & 1;
      const float x0 = static_cast<float>(s * COLS) + 0.5f;
      asm volatile("cp.async.wait_group 0;");
      __syncthreads();   // strip s has landed; strip s - 1's reads are done
      {
        // Ex for columns 8j + 2t, + 1 and gaussians 16 warp + g, + 8.
        const int k0 = 16 * warp + g, k1 = k0 + 8;
        const float p0 = S.px[k0], p1 = S.px[k1], a0 = S.a2[k0],
                    a1 = S.a2[k1];
#pragma unroll
        for (int j = 0; j < STEPS; ++j) {
          const float xa = x0 + static_cast<float>(8 * j + 2 * t);
          const float xb = xa + 1.f;
          const float u0 = xa - p0, u1 = xa - p1, v0 = xb - p0, v1 = xb - p1;
          S.ex[j][warp][lane] = make_float4(expf(a0 * (u0 * u0)),
                                            expf(a1 * (u1 * u1)),
                                            expf(a0 * (v0 * v0)),
                                            expf(a1 * (v1 * v1)));
        }
      }
      __syncthreads();   // Ex (and at a band's start Ey) are formed
      if (s + 1 < s_end) issue(s + 1, buf ^ 1);
      asm volatile("cp.async.commit_group;");
      const float* B = S.band[buf];

      // P1: d = this strip's gG^T, restarted every strip.
      float d[FEAT][4][4];
#pragma unroll
      for (int f = 0; f < FEAT; ++f)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[f][m][i] = 0.f;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) split4(S.ex[j][m][lane], ab[m], as[m]);
#pragma unroll
        for (int f = 0; f < FEAT; ++f) {
          const float2 b = *reinterpret_cast<const float2*>(
              B + swz(f * SUB + 8 * warp + g, 8 * j + 2 * t));
          uint32_t bb0, bb1, bs0, bs1;
          split(b.x, bb0, bs0);
          split(b.y, bb1, bs1);
#pragma unroll
          for (int m = 0; m < 4; ++m)
            mma3(d[f][m], ab[m], as[m], bb0, bb1, bs0, bs1);
        }
      }
#pragma unroll
      for (int f = 0; f < FEAT; ++f)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) run[f][m][i] += d[f][m][i];

      // P2: per n-tile, H_f^T for the warp's 32 gaussians, then gEx and
      // its moments.
#pragma unroll 1
      for (int n = 0; n < 4; ++n) {
        const int j = ch + 2 * n;
        float h[FEAT][2][4];
#pragma unroll
        for (int f = 0; f < FEAT; ++f)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) h[f][m][i] = 0.f;
#pragma unroll
        for (int q = 0; q < RSTEPS; ++q) {
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            split4(S.ey[q][2 * hw + m][lane], ab[m], as[m]);
#pragma unroll
          for (int f = 0; f < FEAT; ++f) {
            const int r = f * SUB + 8 * q + t;
            uint32_t bb0, bb1, bs0, bs1;
            split(B[swz(r, 8 * j + g)], bb0, bs0);
            split(B[swz(r + 4, 8 * j + g)], bb1, bs1);
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma3(h[f][m], ab[m], as[m], bb0, bb1, bs0, bs1);
          }
        }
        // h[f][m]: (gaussian 16 mt + g, column 8j + 2t), (g, 2t + 1),
        // (g + 8, 2t), (g + 8, 2t + 1): Ex's A fragment (j, mt) holds Ex at
        // those pairs as x, z, y, w.
        const float xc = x0 + static_cast<float>(8 * j + 2 * t);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int mt = 2 * hw + m;
          const float4 e4 = S.ex[j][mt][lane];
          const float ex[4] = {e4.x, e4.z, e4.y, e4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = 16 * mt + g + 8 * (i >> 1);
            float gex = h[0][m][i] * S.fo[0][k];
#pragma unroll
            for (int f = 1; f < FEAT; ++f)
              gex = fmaf(h[f][m][i], S.fo[f][k], gex);
            const float tx = (xc + static_cast<float>(i & 1)) - S.px[k];
            const float t1 = (gex * ex[i]) * tx;
            sdx[m][i >> 1] += t1;
            sxx[m][i >> 1] = fmaf(t1, tx, sxx[m][i >> 1]);
          }
        }
      }
    }

    // The band's end: g_featop, gEy, Mdy and Myy from gG^T. run[f][m]:
    // (gaussian 16m + g, row 8 warp + 2t), (g, 2t + 1), (g + 8, 2t),
    // (g + 8, 2t + 1). Ey at a row 8 warp + rr sits in the Ey fragment of
    // lane g*4 + (rr & 3), component 2 (rr >> 2) + (gaussian g + 8).
    const float* eyf = reinterpret_cast<const float*>(S.ey[warp]);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = 16 * m + g + 8 * hh;
        float q[NQ];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = 2 * t + e;
          const float ey = eyf[(m * 32 + g * 4 + (rr & 3)) * 4
                               + 2 * (rr >> 2) + hh];
          const float ty = (y0 + static_cast<float>(8 * warp + rr)) - S.py[k];
          float gey = run[0][m][2 * hh + e] * S.fo[0][k];
#pragma unroll
          for (int f = 1; f < FEAT; ++f)
            gey = fmaf(run[f][m][2 * hh + e], S.fo[f][k], gey);
          const float t2 = (gey * ey) * ty;
#pragma unroll
          for (int f = 0; f < FEAT; ++f)
            q[f] = e ? fmaf(run[f][m][2 * hh + e], ey, q[f])
                     : run[f][m][2 * hh + e] * ey;
          q[FEAT] = e ? q[FEAT] + t2 : t2;
          q[FEAT + 1] = e ? fmaf(t2, ty, q[FEAT + 1]) : t2 * ty;
        }
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const float v = quad_sum(q[i]);
          if (m == t) bq[hh][i] += v;
        }
      }
  }

  // Every row's sums across warps, in a fixed order, through the first
  // strip buffer: P1's per warp, P2's per column half.
  __syncthreads();
  float* red1 = S.band[0];                  // [4 warps][KC][NQ]
  float* red2 = red1 + 4 * KC * NQ;         // [2 halves][KC][2]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      red1[(warp * KC + 16 * t + g + 8 * hh) * NQ + i] = bq[hh][i];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float vdx = quad_sum(sdx[m][hh]), vxx = quad_sum(sxx[m][hh]);
      if (t == 0) {
        const int k = 16 * (2 * hw + m) + g + 8 * hh;
        red2[(ch * KC + k) * 2 + 0] = vdx;
        red2[(ch * KC + k) * 2 + 1] = vxx;
      }
    }
  __syncthreads();
  if (threadIdx.x < KC) {
    const int k = threadIdx.x;
    float v[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      v[i] = ((red1[(0 * KC + k) * NQ + i] + red1[(1 * KC + k) * NQ + i])
              + red1[(2 * KC + k) * NQ + i]) + red1[(3 * KC + k) * NQ + i];
    const float mdx = red2[k * 2 + 0] + red2[(KC + k) * 2 + 0];
    const float mxx = red2[k * 2 + 1] + red2[(KC + k) * 2 + 1];
    float4* o = reinterpret_cast<float4*>(
        dst + (static_cast<size_t>(blockIdx.y) * n_pad + k_base + k) * GD);
    o[0] = make_float4(mdx, v[FEAT], mxx, 0.f);
    o[1] = make_float4(v[FEAT + 1], 0.f, v[0], v[1]);
    o[2] = make_float4(v[2], v[3], v[4], 0.f);
    o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// out = the slices' rows summed in slice order, one float4 a thread.
__global__ void __launch_bounds__(RED_THREADS)
splat_sep_bwd_sum_kernel(const float4* __restrict__ part,
                         float4* __restrict__ out, int n4, int slices) {
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int k = 1; k < slices; ++k) {
    const float4 p = part[static_cast<size_t>(k) * n4 + i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  out[i] = s;
}

}  // namespace

// The slices the launcher cuts these shapes into; the scratch `part` holds
// that many (n_pad, 16) planes (none is needed for one).
extern "C" int splat_sep_bwd_slices(int rows, int wp, int n_pad) {
  return slicing(rows, wp, n_pad).slices;
}

extern "C" cudaError_t splat_sep_bwd_launch(const int* lo, const int* cnt,
                                            const float* gdata,
                                            const float* gband, float* part,
                                            float* out, int n_bands, int rows,
                                            int wp, int nb, int n_pad,
                                            cudaStream_t stream) {
  if ((rows != 32 && rows != 64) || wp <= 0 || wp % COLS || nb <= 0
      || nb % KC || n_pad <= 0 || n_pad % nb || n_bands <= 0)
    return cudaErrorInvalidValue;
  const Slicing sl = slicing(rows, wp, n_pad);
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t attr = cudaFuncSetAttribute(
      splat_sep_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (attr != cudaSuccess) return attr;
  splat_sep_bwd_kernel<<<dim3(n_pad / KC, sl.slices), THREADS, sizeof(Smem),
                         stream>>>(
      lo, cnt, gdata, gband, sl.slices > 1 ? part : out, n_bands, rows, wp,
      nb, n_pad, sl.col_slices, sl.strips_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sl.slices == 1) return err;
  const int n4 = n_pad * GD / 4;
  splat_sep_bwd_sum_kernel<<<(n4 + RED_THREADS - 1) / RED_THREADS,
                             RED_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      n4, sl.slices);
  return cudaGetLastError();
}

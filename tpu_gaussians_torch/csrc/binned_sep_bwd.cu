// Tile-binned separable (axis footprint) accumulation, backward (K7b).
//
// Replaces the TPU kernel
// tpu_gaussians/ops/pallas/binned.py:_binned_bwd_kernel_sep, launched there
// by _binned_call via _binned_bwd_call(sep=True). Given the cotangent g8
// (8, n_tiles*2048) of K7a's output (binned_sep_fwd.cu), read as
// gband[(f, r), c] per 16x128-pixel tile, and for each slot of the 512-slot
// chunks j of tile t with j * 512 < cnt[t], with Ex, Ey, featsop as in K7a
// and tx = x_c - px, ty = y_r - py:
//
//   gG2[f, r] = sum_c gband[f, r, c] Ex[c]              (TPU: gband . Ex)
//   gEx[c]    = sum_(f, r) gband[f, r, c] featsop_f Ey[r] (TPU: gband^T . G2)
//   g_featop_f = sum_r gG2[f, r] Ey[r],  gEy[r] = sum_f gG2[f, r] featsop_f
//   u_x = gEx Ex: Mdx = sum_c u_x tx, Mxx = sum_c u_x tx^2
//   u_y = gEy Ey: Mdy = sum_r u_y ty, Myy = sum_r u_y ty^2
//
// and writes the slot's row [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop(8), 0, 0] of
// out (n_tiles*cap, 16). The rows of a chunk at or past cnt[t] are zero. A
// processed chunk's slots past cnt hold the dead row (op 0, a = c = 1, at
// the origin): its featsop is 0, so are its moments, but its g_featop is
// not where Ex and Ey of the origin do not underflow; the kernel computes
// those slots as any other, as the TPU kernel does.
// ops/binned.moment_postpass_opfold turns the rows into gradients of the
// slot rows (g_feat = op g_featop, g_op = sum_f feats_f g_featop_f).
//
// Bound. Per slot of a processed chunk the function needs the two factor
// products, each 16 slots x 128 x 128 per m-tile: 32 flops per (slot,
// pixel) pair, which the TPU runs on its matrix unit; on this card they go
// to the tensor cores in TF32 split three ways (3 x 32 x 2048 flops a slot
// at 2048 per SM and clock), above the 16 + 128 exps (16 per SM and clock),
// the f32 work of G2 and the moments and far above the bytes (64 B a slot
// read and written, the tile's g8 read once). The products decide it at the
// 100k-gaussian 512x512 scene and on the flagship's 128x128 frames
// (chip_smoke's binned_sep_bwd_bound prints the terms). The splits, the
// re-reads of g8 (once per block) and the dead slots are this design's or
// the contract's cost, not the function's.
//
// Design: a warp owns one m-tile of 16 slots of one tile and a range of the
// tile's columns, and runs both products on the tensor cores; the slot
// operands are formed in its own registers, so its warps never wait on each
// other inside the products.
//   - mma.sync.m16n8k8 in TF32, each operand split as x = big + small (big
//     the TF32 part of x, small the exact remainder), big.big' + big.small'
//     + small.big' (K1's, K2's and K7a's arithmetic; one TF32 product fails
//     the tolerance, as tests/test_torch_port_binned_sep_bwd_tc.py shows):
//       P2  gEx (16 slots x 64 columns of a strip) = G2^T . gband, k over
//           the 128 rows (f, r): 16 k-steps x 8 n-tiles, 32 sums a lane;
//       P1  gG2^T (16 slots x 128 rows (f, r)) += Ex^T . gband^T, k over
//           the strip's columns: 8 k-steps x 16 n-tiles, 64 sums a lane.
//     P1's k index is permuted (k = t -> column 2t, t + 4 -> 2t + 1 of the
//     step's 8): its B is then one 8-byte load, and its A at step i holds
//     Ex at exactly the (slot, column) pairs of P2's accumulator at n-tile
//     i, whose Mdx and Mxx terms are folded at once.
//   - A strip runs P2 first; then P1's steps form Ex (4 exps a lane and
//     step), fold P2's n-tile of the same columns into Mdx and Mxx and run
//     P1's products. After the warp's last strip, P1's sums fold into
//     g_featop, gEy and so Mdy and Myy. Ex is formed once; Ey at the 4 rows
//     of P2's A fragments and at the 4 rows of P1's accumulator (16 exps a
//     lane). Every exp is one ex2.approx with log2(e) folded into the conic
//     (K7a's).
//   - gband (the tile's 128 rows x 128 columns) is split once, as a block
//     stages it (its 16 float4 loads a thread all in flight first), into a
//     big and a small plane (2 x 68 KB), rows padded to 136 floats: P1's
//     reads (rows 8j + g, an 8-byte column pair) and P2's (rows 8k + t,
//     column g) then hit 32 banks, and every load is a lane's base address
//     plus a constant. Splitting at every load instead was 7% slower at the
//     100k scene, with 4-warp blocks two an SM; (big, small) pairs
//     interleaved, one load for both, 10% slower (the compiler moves the
//     pairs into HMMA's register order) (tools/ab_k7b.py, PERF.md).
//   - Sums in a fixed order: each mma accumulator over one product's whole
//     reduction (128 terms, or a column slice's 64), started from zero;
//     Mdx, Mxx per lane over its columns in order, g_featop over its rows,
//     gEy over the features; the 4 lanes of a slot by a fixed butterfly;
//     column slices added in slice order through shared memory. No
//     atomics: two launches give the same bits.
//   - Filling the card from host shapes alone (`slicing`): a block of 8
//     warps owns 128 slots a group and walks up to 4 groups of its tile
//     (one staging of gband for up to 512 slots); when the shapes give few
//     blocks, the groups drop to 1 and then each block's warps split the
//     tile's columns into 2 halves (64 slots a block), whose partials the
//     first half's warps add. Nothing is read on the host: a block whose
//     slots start at or past its tile's processed-chunk end writes zero
//     rows and exits.
//   - 254 registers a thread and no spill: one block of 8 warps an SM
//     (142 KB of shared memory).
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows [px, py, conic_a,
// conic_b, conic_c, op, feats(8), 0, 0] (ops/sorted.pack_gdata gathered by
// the binner's slots; the slots past cnt are the dead row), 16-byte
// aligned; cnt (n_tiles,) int32; g8 (8, n_tiles*2048) f32, pixel l = r*128
// + c of tile t at column t*2048 + l, 16-byte aligned (float4 loads); cap
// a multiple of 512. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TH = 16;                    // tile height (rows)
constexpr int TWC = 128;                  // tile width (columns)
constexpr int TPS = TH * TWC;             // pixels per tile
constexpr int NBS = 512;                  // slots per chunk; cap % NBS == 0
constexpr int GD = 16;                    // floats per slot row
constexpr int FEAT = 8;                   // cotangent rows
constexpr int FR = FEAT * TH;             // gband rows (f, r)
constexpr int BS = TWC + 8;               // floats per staged gband row
constexpr int PLANE = FR * BS;            // floats per staged plane
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 16;                    // slots per warp and group
constexpr int STRIP = 64;                 // columns per strip
constexpr int NS = STRIP / 8;             // P2 n-tiles = P1 k-steps a strip
constexpr int KS = FR / 8;                // P2 k-steps = P1 n-tiles
constexpr int MAX_GROUPS = 4;             // groups a block walks
constexpr int MAX_SLICES = TWC / STRIP;   // column slices of a block
constexpr long TARGET_BLOCKS = 2048;      // blocks a launch aims at
constexpr int NQ = 4 + FEAT;              // Mdx Mdy Mxx Myy g_featop(8)
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
  float band[2 * PLANE];                  // gband's big, then small plane
  float red[WARPS][MT][NQ];               // the column slices' partials
};

// The groups and column slices of a launch at these shapes.
struct Slicing {
  int groups, slices;
  int block_slots() const { return MT * (WARPS / slices) * groups; }
};

// The most groups (4, 2, 1), then the fewest slices (1, 2), with which the
// (tile, slot block) grid holds about TARGET_BLOCKS blocks.
Slicing slicing(int n_tiles, int cap) {
  Slicing s{MAX_GROUPS, 1};
  auto blocks = [&] {
    return static_cast<long>(n_tiles) * (cap / s.block_slots());
  };
  while (s.groups > 1 && blocks() < TARGET_BLOCKS) s.groups /= 2;
  while (s.slices < MAX_SLICES && blocks() < TARGET_BLOCKS) s.slices *= 2;
  return s;
}

// x = big + small: big is x with the 13 low mantissa bits cleared (a TF32
// value), small the exact f32 remainder, which the tensor core reads to
// TF32 precision (K1's split).
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A lane's sums of its two slots: v[h] for slot g + 8h of the m-tile.
struct Sums {
  float v[2][NQ];                         // Mdx Mdy Mxx Myy g_featop(8)
};

// One m-tile's sums over the columns [c_lo, c_lo + width) of the staged
// tile, as lane (g, t) holds them before the lanes are added; r0: the slot
// row of slot g (slot g + 8's is 8 rows on).
__device__ __forceinline__ void mtile(const float* __restrict__ band,
                                      const float* __restrict__ r0, float x0,
                                      float y0, int c_lo, int width, int g,
                                      int t, Sums& out) {
  // The lane's slot parameters, h = 0 for slot g, 1 for slot g + 8; Ey at
  // the rows of P1's accumulator (eyc, row_c) and of P2's A fragments (eya,
  // row_a), q = 0..3.
  auto row_c = [t](int q) { return 8 * (q >> 1) + 2 * t + (q & 1); };
  auto row_a = [t](int q) { return 8 * (q >> 1) + t + 4 * (q & 1); };
  float px[2], py[2], ah[2], fo[2][FEAT], eyc[2][4], eya[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4* row = reinterpret_cast<const float4*>(r0 + 8 * h * GD);
    const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3];
    px[h] = q0.x;
    py[h] = q0.y;
    ah[h] = (-0.5f * LOG2E) * q0.z;
    const float ch = (-0.5f * LOG2E) * q1.x, op = q1.y;
    const float fe[FEAT] = {q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, q3.x, q3.y};
#pragma unroll
    for (int f = 0; f < FEAT; ++f) fo[h][f] = fe[f] * op;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float tc = (y0 + static_cast<float>(row_c(q))) - py[h];
      const float ta = (y0 + static_cast<float>(row_a(q))) - py[h];
      eyc[h][q] = ex2(ch * (tc * tc));
      eya[h][q] = ex2(ch * (ta * ta));
    }
  }
  float mdx[2] = {0.f, 0.f}, mxx[2] = {0.f, 0.f};
  // P1's sums, n-tile j = rows (f, r) 8j .. 8j + 7: (slot g, row 8j + 2t),
  // (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1).
  float acc1[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[j][i] = 0.f;

#pragma unroll 1
  for (int cs = c_lo; cs < c_lo + width; cs += STRIP) {
    const float* b1 = band + g * BS + cs + 2 * t;    // P1's B at j = i = 0
    const float* b2 = band + t * BS + cs + g;        // P2's B at k = n = 0
    // P2: gEx for the strip's columns, n-tile n = columns cs + 8n ..: (slot
    // g, column cs + 8n + 2t), (g, + 1), (g + 8, 2t), (g + 8, 2t + 1).
    float acc2[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[n][i] = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      // A: G2 at (slot g / g + 8, row (f, r) = 8k + t, 8k + t + 4).
      const int f = k >> 1, e0 = 2 * (k & 1);
      uint32_t ab[4], as[4];
      split(fo[0][f] * eya[0][e0], ab[0], as[0]);
      split(fo[1][f] * eya[1][e0], ab[1], as[1]);
      split(fo[0][f] * eya[0][e0 + 1], ab[2], as[2]);
      split(fo[1][f] * eya[1][e0 + 1], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* b = b2 + 8 * k * BS + 8 * n;
        mma3(acc2[n], ab, as, __float_as_uint(b[0]),
             __float_as_uint(b[4 * BS]), __float_as_uint(b[PLANE]),
             __float_as_uint(b[PLANE + 4 * BS]));
      }
    }
    // P1 over the strip's 8 k-steps: Ex at columns c = cs + 8i + 2t, c + 1.
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float xa = x0 + static_cast<float>(cs + 8 * i + 2 * t);
      float tx[2][2], ex[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          tx[h][e] = (xa + static_cast<float>(e)) - px[h];
          ex[h][e] = ex2(ah[h] * (tx[h][e] * tx[h][e]));
          const float t1 = (acc2[i][2 * h + e] * ex[h][e]) * tx[h][e];
          mdx[h] += t1;
          mxx[h] = fmaf(t1, tx[h][e], mxx[h]);
        }
      uint32_t ab[4], as[4];
      split(ex[0][0], ab[0], as[0]);
      split(ex[1][0], ab[1], as[1]);
      split(ex[0][1], ab[2], as[2]);
      split(ex[1][1], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float* b = b1 + 8 * j * BS + 8 * i;
        const uint2 bb = *reinterpret_cast<const uint2*>(b);
        const uint2 bs = *reinterpret_cast<const uint2*>(b + PLANE);
        mma3(acc1[j], ab, as, bb.x, bb.y, bs.x, bs.y);
      }
    }
  }

  // P1's sums into g_featop (over the lane's 4 rows, in order) and gEy
  // (over the features, in order), then Mdy and Myy.
  float gey[2][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int f = j >> 1;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * (j & 1) + e;
        const float v = acc1[j][2 * h + e];
        float& s = out.v[h][4 + f];
        s = q ? fmaf(v, eyc[h][q], s) : v * eyc[h][q];
        gey[h][q] = f ? fmaf(v, fo[h][f], gey[h][q]) : v * fo[h][f];
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mdy = 0.f, myy = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float ty = (y0 + static_cast<float>(row_c(q))) - py[h];
      const float t2 = (gey[h][q] * eyc[h][q]) * ty;
      mdy = q ? mdy + t2 : t2;
      myy = q ? fmaf(t2, ty, myy) : t2 * ty;
    }
    out.v[h][0] = mdx[h];
    out.v[h][1] = mdy;
    out.v[h][2] = mxx[h];
    out.v[h][3] = myy;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
binned_sep_bwd_kernel(const float* __restrict__ gdense,
                      const int* __restrict__ cnt,
                      const float* __restrict__ g8, float* __restrict__ out,
                      int tiles_x, int n_tiles, int cap, int groups,
                      int slices) {
  extern __shared__ float4 smem[];
  Smem& S = *reinterpret_cast<Smem*>(smem);

  const int tile = blockIdx.x;
  const int sgs = WARPS / slices;             // slot groups a block step
  const int block_slots = MT * sgs * groups;
  const int first = blockIdx.y * block_slots;
  const int live = min(max(cnt[tile], 0), cap);
  const int end = min((live + NBS - 1) / NBS * NBS, cap);   // processed
  const size_t base = static_cast<size_t>(tile) * cap;
  if (first >= end) {                         // uniform in the block
    float4* dst = reinterpret_cast<float4*>(out + (base + first) * GD);
    for (int k = threadIdx.x; k < block_slots * GD / 4; k += THREADS)
      dst[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // The tile's gband, row (f, r) = 16 f + r, split into its two planes:
  // every load in flight first, then the splits and stores.
  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  const float* gt = g8 + static_cast<size_t>(tile) * TPS;
  constexpr int PER = FR * TWC / 4 / THREADS;        // float4 a thread
  float4 vs[PER];
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int row = i / (TWC / 4), c = 4 * (i % (TWC / 4));
    vs[it] = *reinterpret_cast<const float4*>(
        gt + (row / TH) * plane + (row % TH) * TWC + c);
  }
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int row = i / (TWC / 4), c = 4 * (i % (TWC / 4));
    const float4 v = vs[it];
    uint4 big, small;
    split(v.x, big.x, small.x);
    split(v.y, big.y, small.y);
    split(v.z, big.z, small.z);
    split(v.w, big.w, small.w);
    *reinterpret_cast<uint4*>(&S.band[row * BS + c]) = big;
    *reinterpret_cast<uint4*>(&S.band[PLANE + row * BS + c]) = small;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = warp / sgs, sg = warp % sgs;  // column slice, slot group
  const int width = TWC / slices;
  const float x0 = static_cast<float>((tile % tiles_x) * TWC) + 0.5f;
  const float y0 = static_cast<float>((tile / tiles_x) * TH) + 0.5f;

#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    const size_t slot0 = base + first + MT * (grp * sgs + sg);
    Sums s;
    mtile(S.band, gdense + (slot0 + g) * GD, x0, y0, q * width, width, g, t,
          s);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < NQ; ++i) s.v[h][i] = quad_sum(s.v[h][i]);
    if (slices > 1) {                         // uniform in the block
      if (q > 0 && t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < NQ; ++i) S.red[warp][g + 8 * h][i] = s.v[h][i];
      }
      __syncthreads();
      if (q == 0) {                           // slices in order
        for (int qs = 1; qs < slices; ++qs)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < NQ; ++i)
              s.v[h][i] += S.red[qs * sgs + sg][g + 8 * h][i];
      }
      __syncthreads();                        // red is free again
      if (q > 0) continue;
    }
    // Lane t writes float4 t of the rows of slots g and g + 8.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* v = s.v[h];
      float4 w;
      if (t == 0) w = make_float4(v[0], v[1], v[2], 0.f);
      else if (t == 1) w = make_float4(v[3], 0.f, v[4], v[5]);
      else if (t == 2) w = make_float4(v[6], v[7], v[8], v[9]);
      else w = make_float4(v[10], v[11], 0.f, 0.f);
      reinterpret_cast<float4*>(out + (slot0 + g + 8 * h) * GD)[t] = w;
    }
  }
}

}  // namespace

// The column slices (1 or 2) into which a block's warps split each tile
// for these shapes.
extern "C" int binned_sep_bwd_col_slices(int n_tiles, int cap) {
  return slicing(n_tiles, cap).slices;
}

extern "C" cudaError_t binned_sep_bwd_launch(const float* gdense,
                                             const int* cnt, const float* g8,
                                             float* out, int tiles_x,
                                             int n_tiles, int cap,
                                             cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  const Slicing sl = slicing(n_tiles, cap);
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      binned_sep_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return err;
  binned_sep_bwd_kernel<<<dim3(n_tiles, cap / sl.block_slots()), THREADS,
                          sizeof(Smem), stream>>>(
      gdense, cnt, g8, out, tiles_x, n_tiles, cap, sl.groups, sl.slices);
  return cudaGetLastError();
}

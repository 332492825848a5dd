// Tile-binned separable (axis footprint) accumulation, forward (K7a).
//
// Replaces the TPU kernel
// tpu_gaussians/ops/pallas/binned.py:_binned_fwd_kernel_sep (factors
// _sep_tile_factors), launched there by _binned_call via
// _binned_fwd_call(sep=True). Conic b is 0 by the axis contract, so a slot's
// weight factorises over the 16x128-pixel tile t (centres at +0.5):
//
//   Ex[s, c] = exp(-a/2 (x_c - px)^2),  Ey[s, r] = exp(-c/2 (y_r - py)^2)
//   acc[(f, r), c] += G2[(f, r), s] Ex[s, c],   G2 = featsop_f Ey[s, r]
//
// (featsop = feats op) over the slots s of the tile's list, one matrix
// product per tile: M = 8 features x 16 rows, N = 128 columns, K = the
// slots. It writes acc (8, n_tiles*2048), pixel l of tile t at column
// t*2048 + l (l = r*128 + c): the layout of K8a (binned_fwd.cu), every
// element (zeros for a tile with cnt 0). The TPU kernel runs whole 512-slot
// chunks below cnt; this one stops at cnt rounded up to 64 slots. Slots past
// cnt are the dead row (op 0, ops/sorted.pack_gdata), which adds exact
// zeros either way. Row 3 (conic b) is not read.
//
// Bound. Per live slot and tile the function needs the product's 16 flops
// for each of the tile's 2048 pixels, which the TPU runs on its matrix
// unit; on this card they go to the tensor cores in TF32 split three ways
// (3 x 16 x 2048 flops at 2048 per SM and clock), above the 16 + 128 exps
// (16 per SM and clock), the 128 multiplies of G2 (f32 rate) and far above
// the bytes (64 B a slot read, the sums written once). The product decides
// it at the 100k-gaussian 512x512 scene and on the flagship's 128x128
// frames (chip_smoke's binned_sep_fwd_bound prints the terms). The splits,
// the second exps of Ey (one per column half) and the slice partials are
// this design's cost, not the function's: chip_smoke reports the partials'
// bytes beside the bound.
//
// Design: K1's split-K product (csrc/splat_sep_fwd.cu) over a tile's slot
// list, with the list cut into slices as K8a cuts it.
//   - A block of 4 warps owns one 64-column half of a tile (all 8 features
//     x 16 rows) and one slice of the tile's list; the grid is (tile, half)
//     x slice. A warp owns 4 features x 32 columns: 4 x 4 mma tiles, 64
//     running sums and 64 chunk sums a thread.
//   - The product runs on the tensor cores, mma.sync.m16n8k8 in TF32: A is
//     G2 (the tile's 16 rows of one feature x 8 slots: one m16 fragment),
//     B is Ex (8 slots x 8 columns). Each operand is split as x = big +
//     small, big the TF32 part of x (low 13 mantissa bits cleared) and
//     small the exact remainder, and big.big' + big.small' + small.big'
//     keeps near-f32 accuracy (one TF32 product fails the 1e-5 check, as
//     tests/test_torch_port_binned_sep_tc.py shows).
//   - Both operands are generated per chunk of 64 slots into shared memory
//     in the mma fragment order, one float4 per lane and tile: Ex from one
//     exp per (slot, column) of the block's half, G2 from one exp per (slot,
//     row) and 8 multiplies. A warp's fragment load is 512 contiguous bytes
//     (no bank conflict), and so is a generating warp's store. The split is
//     paid at the load: splitting once at generation and storing both parts
//     was 5% slower at the 100k scene (twice the shared-memory loads).
//   - Each exp is one ex2.approx with log2(e) folded into the conic: 9%
//     faster at the 100k scene than expf, within the same tolerance (its
//     relative error near 2^-22; results below 2^-126 flush to 0).
//   - The chunk's rows arrive by cp.async; the next chunk's copy is issued
//     once this chunk's operands are generated, so it overlaps the
//     products.
//   - The slices fill the card: the slice length, a multiple of the chunk
//     and at least MIN_SLICE slots, comes from what the host knows
//     (n_tiles, cap), so that the grid holds about TARGET_BLOCKS blocks. No
//     count is read on the host: a block whose slice starts at or past its
//     tile's cnt exits at once; slice 0 of every tile always writes. With
//     one slice the block writes acc itself and no second kernel runs.
//   - Sums in three levels, in a fixed order: each 64-slot chunk in the mma
//     accumulator (restarted every chunk, so the tensor core's own rounding
//     stays near f32's), the chunk partials into f32 registers in chunk
//     order, and the slices' partials, which a second kernel adds in slice
//     order. No atomics: two launches give the same bits.
//
//   - 64 running sums and 64 chunk sums a thread: 211 registers, no spill;
//     two blocks fit on an SM, with 52 KB of shared memory each.
//
// What holds it above the bound (tools/ab_k7a.py's variants of this file
// on the 100k scene's lists, PERF.md): mma.sync TF32 holds an SM
// sub-partition 6.81 cycles against the rate's 4.00 (tools/pipe_rates.py),
// which caps this design at about 59% of the bound; the tensor pipe is busy
// about half the time. With one product of three it is 22% faster, without
// the exps 4%; the rest is the issue that does not overlap the products:
// fragment loads and splits, generating the operands while the block's
// products wait at its barrier, and the slice sum (4%). One slice a tile
// is 1.5x slower (3x on the flagship's 8 tiles), twice the slices and
// 128-slot chunks within 3%.
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows [px, py, conic_a,
// conic_b, conic_c, op, feats(8), 0, 0] (ops/sorted.pack_gdata gathered by
// the binner's slots), 16-byte aligned; cnt (n_tiles,) int32; cap a
// multiple of 512; part (S, 8, n_tiles*2048) f32 scratch when S > 1
// (binned_sep_fwd_slice_len gives the slice length, S = ceil(cap /
// length)). Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TH = 16;                    // tile height (rows)
constexpr int TWC = 128;                  // tile width (columns)
constexpr int TPS = TH * TWC;             // pixels per tile
constexpr int NBS = 512;                  // cap % NBS == 0
constexpr int GD = 16;                    // floats per slot row
constexpr int FEAT = 8;                   // output rows
constexpr int THREADS = 128;
constexpr int COLS = 64;                  // columns per block
constexpr int HALVES = TWC / COLS;        // blocks per tile and slice
constexpr int FW = 4;                     // features per warp
constexpr int NT = 4;                     // 8-column mma tiles per warp
constexpr int KC = 64;                    // slots per chunk
constexpr int STEPS = KC / 8;             // 8-slot mma steps per chunk
constexpr int MIN_SLICE = 128;            // slots per slice, at least
constexpr long TARGET_BLOCKS = 2048;      // blocks a launch aims at
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// A chunk as cp.async lands it, and its operands in fragment order: G2 for
// (step, feature, lane) and Ex for (step, 32-column half, pair of 8-column
// tiles, lane).
struct Stage {
  float4 raw[KC * GD / 4];                // 4 KB
  float4 a[STEPS][FEAT][32];              // 32 KB
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src));
}

// Slots per slice of a tile's list: a multiple of KC, at least MIN_SLICE
// and at most cap, such that the (tile, half) x ceil(cap / slice) grid
// holds about TARGET_BLOCKS blocks.
int slice_len(int n_tiles, int cap) {
  long len = (static_cast<long>(n_tiles) * HALVES * cap + TARGET_BLOCKS - 1)
             / TARGET_BLOCKS;
  len = (len + KC - 1) / KC * KC;
  if (len < MIN_SLICE) len = MIN_SLICE;
  return static_cast<int>(len < cap ? len : cap);
}

__device__ __forceinline__ int live_slots(const int* cnt, int tile, int cap) {
  return min(max(cnt[tile], 0), cap);
}

// The staged chunk's operands, thread slot by slot, for the block's columns
// from x0 and the tile's rows from y0 (pixel centres). Ex: slot (step,
// column half, tile pair, lane g*4 + t) holds Ex at columns c and c + 8 (c
// the lane's column g of the first tile) for slots t and t + 4 of the step,
// as B's fragments (b0, b1) of the two tiles. G2: slot (step, feature,
// lane) holds A's fragment: rows g, g + 8 for slots t, t + 4.
__device__ __forceinline__ void generate(Stage& S, float x0, float y0) {
  const float* raw = reinterpret_cast<const float*>(S.raw);
  for (int i = threadIdx.x; i < STEPS * 2 * (NT / 2) * 32; i += THREADS) {
    const int lane = i & 31, jp = (i >> 5) & 1, wn = (i >> 6) & 1,
              s = i >> 7;
    const int g = lane >> 2, t = lane & 3;
    const float x = x0 + static_cast<float>(wn * 32 + jp * 16 + g);
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {       // (column c or c + 8, slot)
      const float* row = raw + (s * 8 + t + 4 * (q & 1)) * GD;
      const float tx = (x + static_cast<float>(8 * (q >> 1))) - row[0];
      e[q] = ex2((-0.5f * LOG2E * row[2]) * (tx * tx));
    }
    S.b[s][wn][jp][lane] = make_float4(e[0], e[1], e[2], e[3]);
  }
  for (int i = threadIdx.x; i < STEPS * 32; i += THREADS) {
    const int lane = i & 31, s = i >> 5;
    const int g = lane >> 2, t = lane & 3;
    const float* r0 = raw + (s * 8 + t) * GD;       // slot t
    const float* r1 = r0 + 4 * GD;                  // slot t + 4
    const float y = y0 + static_cast<float>(g);
    const float ty00 = y - r0[1], ty01 = (y + 8.f) - r0[1];
    const float ty10 = y - r1[1], ty11 = (y + 8.f) - r1[1];
    const float ch0 = -0.5f * LOG2E * r0[4], ch1 = -0.5f * LOG2E * r1[4];
    const float ey00 = ex2(ch0 * (ty00 * ty00));   // row g, slot t
    const float ey01 = ex2(ch0 * (ty01 * ty01));   // row g + 8
    const float ey10 = ex2(ch1 * (ty10 * ty10));   // row g, slot t + 4
    const float ey11 = ex2(ch1 * (ty11 * ty11));
#pragma unroll
    for (int f = 0; f < FEAT; ++f) {
      const float f0 = r0[6 + f] * r0[5], f1 = r1[6 + f] * r1[5];
      S.a[s][f][lane] =
          make_float4(f0 * ey00, f0 * ey01, f1 * ey10, f1 * ey11);
    }
  }
}

// One staged chunk into d (zeroed by the caller): the warp's features
// (half wf) against its 32 columns (half wn).
__device__ __forceinline__ void chunk(const Stage& S, float (&d)[FW][NT][4],
                                      int wf, int wn, int lane) {
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
    for (int f = 0; f < FW; ++f) {
      const float4 a = S.a[s][wf * FW + f][lane];
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
binned_sep_fwd_kernel(const float* __restrict__ gdense,
                      const int* __restrict__ cnt, float* __restrict__ part,
                      int tiles_x, int n_tiles, int cap, int slice) {
  extern __shared__ float4 smem[];
  Stage& S = *reinterpret_cast<Stage*>(smem);

  const int tile = blockIdx.x / HALVES, half = blockIdx.x % HALVES;
  const int n_live = live_slots(cnt, tile, cap);
  const int start = blockIdx.y * slice;
  if (blockIdx.y > 0 && start >= n_live) return;     // past the list
  const int end = min(start + slice, (n_live + KC - 1) / KC * KC);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wf = warp & 1, wn = warp >> 1;
  const float x0 =
      static_cast<float>((tile % tiles_x) * TWC + half * COLS) + 0.5f;
  const float y0 = static_cast<float>((tile / tiles_x) * TH) + 0.5f;

  float acc[FW][NT][4];
#pragma unroll
  for (int f = 0; f < FW; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][j][i] = 0.f;

  // The slots [base, base + KC) of the tile's list.
  const float* list = gdense + static_cast<size_t>(tile) * cap * GD;
  auto issue = [&](int base) {
    const float* src = list + static_cast<size_t>(base) * GD;
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
    float d[FW][NT][4];
#pragma unroll
    for (int f = 0; f < FW; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[f][j][i] = 0.f;
    chunk(S, d, wf, wn, lane);
#pragma unroll
    for (int f = 0; f < FW; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][j][i] += d[f][j][i];
  }

  // D's layout: (row g, column 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
  const int g = lane >> 2, t = lane & 3;
  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  float* o = part + blockIdx.y * FEAT * plane + static_cast<size_t>(tile) * TPS
             + g * TWC + half * COLS + wn * 32 + 2 * t;
#pragma unroll
  for (int f = 0; f < FW; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* p = o + (wf * FW + f) * plane + j * 8;
      *reinterpret_cast<float2*>(p) = make_float2(acc[f][j][0], acc[f][j][1]);
      *reinterpret_cast<float2*>(p + 8 * TWC) =
          make_float2(acc[f][j][2], acc[f][j][3]);
    }
}

// out = each tile's slice partials summed in slice order: slices 0 ..
// ceil(live / slice) - 1 of its list (at least slice 0), one float4 a
// thread.
__global__ void __launch_bounds__(RED_THREADS)
slice_sum_kernel(const int* __restrict__ cnt, const float4* __restrict__ part,
                 float4* __restrict__ out, int n_tiles, int cap, int slice) {
  const size_t plane4 = static_cast<size_t>(n_tiles) * TPS / 4;
  const size_t i = static_cast<size_t>(blockIdx.x) * RED_THREADS
                   + threadIdx.x;
  if (i >= FEAT * plane4) return;
  const int tile = static_cast<int>(i % plane4 / (TPS / 4));
  const int live = max(1, (live_slots(cnt, tile, cap) + slice - 1) / slice);
  float4 s = part[i];
  for (int k = 1; k < live; ++k) {
    const float4 p = part[k * FEAT * plane4 + i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  out[i] = s;
}

}  // namespace

// The slice length the launcher uses for these shapes; the scratch `part`
// holds ceil(cap / slice_len) slices (none is needed for one).
extern "C" int binned_sep_fwd_slice_len(int n_tiles, int cap) {
  return slice_len(n_tiles, cap);
}

extern "C" cudaError_t binned_sep_fwd_launch(const float* gdense,
                                             const int* cnt, float* part,
                                             float* out, int tiles_x,
                                             int n_tiles, int cap,
                                             cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  const int slice = slice_len(n_tiles, cap);
  const int slices = (cap + slice - 1) / slice;
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t attr = cudaFuncSetAttribute(
      binned_sep_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Stage)));
  if (attr != cudaSuccess) return attr;
  binned_sep_fwd_kernel<<<dim3(n_tiles * HALVES, slices), THREADS,
                          sizeof(Stage), stream>>>(
      gdense, cnt, slices > 1 ? part : out, tiles_x, n_tiles, cap, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const size_t n4 = static_cast<size_t>(FEAT) * n_tiles * TPS / 4;
  slice_sum_kernel<<<static_cast<unsigned>((n4 + RED_THREADS - 1)
                                           / RED_THREADS),
                     RED_THREADS, 0, stream>>>(
      cnt, reinterpret_cast<const float4*>(part),
      reinterpret_cast<float4*>(out), n_tiles, cap, slice);
  return cudaGetLastError();
}

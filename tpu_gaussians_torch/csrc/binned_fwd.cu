// Tile-binned general-conic accumulation, forward (K8a).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/binned.py:_binned_fwd_kernel,
// launched there by _binned_call (via _binned_fwd_call). Per 16x128-pixel
// tile t (pixel centres at +0.5), over the slots s < cnt[t] of its list:
//
//   e = -0.5 (a dx^2 + 2 b dx dy + c dy^2)      (the conic as binned: unscaled)
//   acc[f, p] += feats_f * op * exp(e)           (no cutoff, no clamp)
//
// and writes acc (8, n_tiles*2048), pixel l of tile t at column t*2048 + l
// (l = row*128 + col), every element (zeros for a tile with cnt 0). The TPU
// kernel runs whole 512-slot chunks below cnt; this one stops at cnt rounded
// up to 128 slots. Slots past cnt are the dead row (op 0,
// ops/sorted.pack_gdata), which adds exact zeros either way.
//
// Bound. Per (slot, pixel) pair of the live slots the function needs the
// 8-wide product feats op . w (16 flops, which the TPU runs on its matrix
// unit as a bf16x3 product), one exp, and the exponent (5 flops with the
// row terms b dy and c dy^2 paid once per slot and row and op folded into
// the feature rows); against 64 B read per slot, cnt, and 32 B written per
// pixel. On this card the product goes to the tensor cores, so the exp on
// the SFU (16 per SM and clock) bounds the kernel, above the product's 3 x 16
// TF32 flops, the 5 flops at the f32 rate and far above the bytes. The
// slice partials below are this design's cost, not the function's:
// chip_smoke reports their bytes beside the bound.
//
// Design: K9a's inner loop (csrc/splat_v1_fwd.cu) over a tile's slot list,
// with the list split over blocks as K1 splits a band's range
// (csrc/splat_sep_fwd.cu).
//   - A block of 4 warps owns 512 pixels of one tile, four of its rows (4
//     blocks a tile); a warp owns one row of 128 pixels as eight 16-pixel
//     tiles of mma.sync.m16n8k8, so dy, b dy and c dy^2 are paid once per
//     slot and step, never per pixel.
//   - The feature product runs on the tensor cores in TF32: A is w =
//     exp(e) (16 pixels x 8 slots), B the feature rows times op (8 slots x
//     8 features), D the pixels' 8 sums. Each operand is split 3 ways, x =
//     big + small with big the TF32 part of x (the low 13 mantissa bits
//     cleared) and small the exact remainder, and big.big' + big.small' +
//     small.big' keeps near-f32 accuracy. Lane (g, t) evaluates w in A's
//     own fragment layout: four exps per product, none twice, no shuffle.
//   - op, log2(e) and the split of B are paid once per slot, when its row is
//     staged: a 128-slot chunk lands in shared memory by cp.async, the block
//     turns it into per-lane B fragments and conic rows, and w is one
//     ex2.approx per pair. The next chunk's copy is issued once this chunk
//     is turned, so it overlaps this chunk's math.
//   - The slices fill the card: each block takes one slice of its tile's
//     list, a multiple of 128 slots whose length comes from what the host
//     knows (n_tiles, cap), so that the grid holds about TARGET_BLOCKS
//     blocks. No count is read on the host: a block whose slice starts at
//     or past its tile's cnt exits at once; slice 0 of every tile always
//     writes (zeros for an empty tile). With one slice the block writes
//     acc itself and no second kernel runs.
//   - Sums in three levels, in a fixed order: each 128-slot chunk in the
//     mma accumulator (restarted every chunk: 48 tensor-core additions, so
//     its rounding stays near f32's), the chunk partials into the pixel's
//     f32 total in chunk order, and the slices' partials, which a second
//     kernel adds in slice order. A full tile sums 8192 terms a pixel. No
//     atomics: two launches give the same bits. The exp flushes results
//     below 2^-126 to 0.
//   - The 16 steps of a chunk run two to a loop turn (unrolled by 2: 4%
//     faster at the 100k scene than one, as fast as four), at most 168
//     registers a thread (160), so three blocks fit on an SM.
//
// What holds it above the bound (tools/ab_k8a.py's variants of this file,
// PERF.md): without the exp it is 20% faster, with one product of three
// 16%; the rest is the issue of the per-pair f32 and integer instructions
// (dx, the exponent, the split of w), as in K9a. Warps of 64 pixels (80
// registers, five blocks an SM) were 2% slower; half as many blocks 3%
// slower, twice as many no faster (the slice sum's reads doubled).
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows [px, py, conic_a,
// conic_b, conic_c, op, feats(8), 0, 0] (ops/sorted.pack_gdata gathered by
// the binner's slots), 16-byte aligned; cnt (n_tiles,) int32; cap a
// multiple of 512; part (S, 8, n_tiles*2048) f32 scratch when S > 1
// (binned_fwd_slice_len gives the slice length, S = ceil(cap / length)).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TH = 16;                   // tile height (rows)
constexpr int TWC = 128;                 // tile width (columns)
constexpr int TPS = TH * TWC;            // pixels per tile
constexpr int NBS = 512;                 // cap % NBS == 0
constexpr int GD = 16;                   // floats per slot row
constexpr int FEAT = 8;                  // output rows
constexpr int THREADS = 128;
constexpr int MT = 8;                    // 16-pixel mma tiles per warp
constexpr int WARPS = THREADS / 32;      // tile rows per block
constexpr int QUARTERS = TH / WARPS;     // blocks per tile and slice
constexpr int CHUNK = 128;               // slots staged at a time
constexpr int STEPS = CHUNK / 8;         // 8-slot mma steps per chunk
constexpr long TARGET_BLOCKS = 4096;     // blocks a launch aims at
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// A chunk as cp.async lands it, and turned for the lanes: B fragments
// (bb(t, g), bb(t+4, g), bs(t, g), bs(t+4, g) for lane g*4 + t: slot,
// feature) and per t the conic of slots t and t+4 of each step.
struct Stage {
  float4 raw[CHUNK * GD / 4];            // 8 KB
  float4 bf[STEPS][32];                  // 8 KB
  float4 cx[STEPS][4];                   // px, px', -a/2, -a'/2   (x log2 e)
  float4 cy[STEPS][4];                   // py, py', -b, -b'
  float2 cc[STEPS][4];                   // -c/2, -c'/2
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

// Thread i turns raw row i of the chunk: step i / 8, slot k = i % 8 of the
// step, which lanes with t = k % 4 read in half k / 4 of their operands.
__device__ __forceinline__ void turn(Stage& S, int i) {
  const float4 h0 = S.raw[4 * i];        // px, py, a, b
  const float4 h1 = S.raw[4 * i + 1];    // c, op, f0, f1
  const float4 h2 = S.raw[4 * i + 2];    // f2 .. f5
  const float4 h3 = S.raw[4 * i + 3];    // f6, f7, 0, 0
  const int s = i >> 3, k = i & 7, tq = k & 3, hi = k >> 2;
  float* cx = reinterpret_cast<float*>(&S.cx[s][tq]);
  float* cy = reinterpret_cast<float*>(&S.cy[s][tq]);
  float* cc = reinterpret_cast<float*>(&S.cc[s][tq]);
  cx[hi] = h0.x;
  cx[2 + hi] = -0.5f * LOG2E * h0.z;
  cy[hi] = h0.y;
  cy[2 + hi] = -LOG2E * h0.w;
  cc[hi] = -0.5f * LOG2E * h1.x;
  const float op = h1.y;
  const float f[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};
#pragma unroll
  for (int n = 0; n < FEAT; ++n) {
    uint32_t big, small;
    split(f[n] * op, big, small);
    float* b = reinterpret_cast<float*>(&S.bf[s][n * 4 + tq]);
    b[hi] = __uint_as_float(big);
    b[2 + hi] = __uint_as_float(small);
  }
}

// One staged chunk into d (zeroed by the caller) for the lane's pixels of
// one tile row at y: pixel (m, h) at x0 + 16 m + 8 h.
__device__ __forceinline__ void chunk(const Stage& S, float (&d)[MT][4],
                                      float x0, float y, int lane) {
  const int t = lane & 3;
#pragma unroll 2
  for (int s = 0; s < STEPS; ++s) {
    const float4 b = S.bf[s][lane];
    const float4 cx = S.cx[s][t];
    const float4 cy = S.cy[s][t];
    const float2 cc = S.cc[s][t];
    const float px[2] = {cx.x, cx.y}, ah[2] = {cx.z, cx.w};
    const float py[2] = {cy.x, cy.y}, bh[2] = {cy.z, cy.w};
    const float ch[2] = {cc.x, cc.y};
    float bdy[2], cdy2[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float dy = y - py[j];
      bdy[j] = bh[j] * dy;
      cdy2[j] = (ch[j] * dy) * dy;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // A: (g, k=t), (g+8, t), (g, t+4), (g+8, t+4): pixel half i & 1,
      // slot i >> 1.
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, j = i >> 1;
        const float dx = (x0 + static_cast<float>(16 * m + 8 * h)) - px[j];
        split(ex2(fmaf(dx, fmaf(ah[j], dx, bdy[j]), cdy2[j])), ab[i], as[i]);
      }
      mma3(d[m], ab, as, __float_as_uint(b.x), __float_as_uint(b.y),
           __float_as_uint(b.z), __float_as_uint(b.w));
    }
  }
}

// Slots per slice of a tile's list: a multiple of CHUNK, at most cap, such
// that the (tile, quarter) x ceil(cap / slice) grid holds about
// TARGET_BLOCKS blocks.
int slice_len(int n_tiles, int cap) {
  long len = (static_cast<long>(n_tiles) * QUARTERS * cap + TARGET_BLOCKS
              - 1) / TARGET_BLOCKS;
  len = (len + CHUNK - 1) / CHUNK * CHUNK;
  return static_cast<int>(len < cap ? len : cap);
}

__device__ __forceinline__ int live_slots(const int* cnt, int tile, int cap) {
  return min(max(cnt[tile], 0), cap);
}

__global__ void __launch_bounds__(THREADS, 3)
binned_fwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt, float* __restrict__ part,
                  int tiles_x, int n_tiles, int cap, int slice) {
  __shared__ __align__(16) Stage S;

  const int tile = blockIdx.x / QUARTERS;
  const int n_live = live_slots(cnt, tile, cap);
  const int start = blockIdx.y * slice;
  if (blockIdx.y > 0 && start >= n_live) return;     // past the list
  const int end = min(start + slice, (n_live + CHUNK - 1) / CHUNK * CHUNK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = (blockIdx.x % QUARTERS) * WARPS + warp;   // in the tile
  const float x0 = static_cast<float>((tile % tiles_x) * TWC + g) + 0.5f;
  const float y = static_cast<float>((tile / tiles_x) * TH + row) + 0.5f;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;

  // The slots [base, base + CHUNK) of the tile's list.
  const float* list = gdense + static_cast<size_t>(tile) * cap * GD;
  auto issue = [&](int base) {
    const float* src = list + static_cast<size_t>(base) * GD;
    for (int k = threadIdx.x; k < CHUNK * GD / 4; k += THREADS)
      cp_async16(&S.raw[k], src + 4 * k);
  };
  if (start < end) issue(start);
  asm volatile("cp.async.commit_group;");
  for (int base = start; base < end; base += CHUNK) {
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();   // the chunk has landed; the last chunk's math is over
    turn(S, threadIdx.x);
    __syncthreads();   // turned; the raw buffer is free
    if (base + CHUNK < end) issue(base + CHUNK);
    asm volatile("cp.async.commit_group;");
    float d[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[m][i] = 0.f;
    chunk(S, d, x0, y, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i] += d[m][i];
  }

  // D's layout: (pixel g, feature 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  float* o = part + blockIdx.y * FEAT * plane + static_cast<size_t>(tile) * TPS
             + row * TWC + g;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[(2 * t + (i & 1)) * plane + 16 * m + 8 * (i >> 1)] = acc[m][i];
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
extern "C" int binned_fwd_slice_len(int n_tiles, int cap) {
  return slice_len(n_tiles, cap);
}

extern "C" cudaError_t binned_fwd_launch(const float* gdense, const int* cnt,
                                         float* part, float* out,
                                         int tiles_x, int n_tiles, int cap,
                                         cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  const int slice = slice_len(n_tiles, cap);
  const int slices = (cap + slice - 1) / slice;
  binned_fwd_kernel<<<dim3(n_tiles * QUARTERS, slices), THREADS, 0,
                      stream>>>(gdense, cnt, slices > 1 ? part : out,
                                tiles_x, n_tiles, cap, slice);
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

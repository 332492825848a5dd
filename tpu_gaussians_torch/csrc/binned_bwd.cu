// Tile-binned general-conic accumulation, backward (K8b).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/binned.py:_binned_bwd_kernel,
// launched there by _binned_call (via _binned_bwd_call). Given the cotangent
// g8 (8, n_tiles*2048) of K8a's output (binned_fwd.cu), for each slot of the
// 512-slot chunks j of tile t with j * 512 < cnt[t], summed over the tile's
// 2048 pixels (centres at +0.5), with e and w = op exp(e) as in K8a:
//
//   g_w = sum_f g8[f, p] feats_f,   g_e = w g_w
//   M0 = sum g_e, Mdx = sum g_e dx, Mdy = sum g_e dy, Mxx = sum g_e dx^2,
//   Mxy = sum g_e dx dy, Myy = sum g_e dy^2,   g_feat_f = sum_p g8[f, p] w
//
// and writes the slot's row [Mdx, Mdy, Mxx, Mxy, Myy, M0, g_feat(8), 0, 0] of
// out (n_tiles*cap, 16). The rows of a chunk at or past cnt[t] are zero. A
// dead slot (op 0) has w = 0, so its row is zero too. ops/sorted.
// moment_postpass turns the moments into gradients of the slot rows.
//
// Bound. Per (slot, pixel) pair of the live slots the function needs the two
// 8-wide products g_w = feats . g8 and g_feat += g8 w (32 flops, which the
// TPU runs on its matrix unit as bf16x3 products), one exp, and the
// elementwise terms around them (11 flops with the row terms hoisted and op
// factored out, as K9b's: the same per-pair function); against 64 B read
// per live slot, g8 (32 B per pixel) read once and the (n_tiles*cap, 16)
// rows written once. On this card the products go to the tensor cores, so
// the exp on the SFU (16 per SM and clock) bounds the kernel, above the 3 x
// 32 TF32 flops, the 11 flops at the f32 rate and far above the bytes.
//
// Design: K9b's inner loop (csrc/splat_v1_bwd.cu) over one tile's slot list.
//   - A warp owns 32 slots of one tile as two 16-row tiles of
//     mma.sync.m16n8k8 and walks the tile's pixels 8 at a time, row by row.
//     Each slot sees exactly one tile, so its row is the warp's alone.
//   - op factors out of every sum: with v = exp(e) g_w (so g_e = op v), the
//     warp sums v, v dx, v dx^2 and exp(e) g8, and multiplies by op once at
//     the end.
//   - g_w (16 slots x 8 pixels, K = features) and g_feat / op (16 slots x 8
//     features, K = pixels) are TF32 products, each split 3 ways so that it
//     keeps near-f32 accuracy: x = big + small with big the TF32 part of x
//     (the low 13 mantissa bits cleared), and big.big' + big.small' +
//     small.big'. The second product's K index k is pixel 2k for k < 4 and
//     2(k-4)+1 above: the columns 2t, 2t+1 that lane (g, t) holds of g_w
//     are exactly the k = t, t+4 it needs of exp(e) as A, so no shuffle
//     passes between the two products.
//   - The exponent is one ex2.approx with log2(e) folded into the conic,
//     and its row terms (b dy, c dy^2) are paid once per tile row (16 steps
//     of 8 pixels). Per row each lane sums v, v dx and v dx^2 over its 32
//     pixels and folds them into its running moments at the row's end: Mdy
//     = sum_r dy sum v, Myy = sum_r dy^2 sum v, Mxy = sum_r dy sum v dx.
//     The g_feat accumulator of the mma restarts every row (48 tensor-core
//     additions) and is added into an f32 total in row order.
//   - Each slot's row (the split of feats, the conic times log2(e)) is read
//     once into the lane's registers. The tile's cotangent lands in shared
//     memory by cp.async in four pieces of 512 pixels (8 x 520 floats each,
//     the whole tile: a block never changes tile), each piece its own copy
//     group, so the first piece's math starts while the rest still lands.
//   - Filling the card: a block of 4 warps owns 128, 64 or 32 slots of one
//     tile, its warps split between slot groups and pixel slices (1, 2 or
//     4 slices of the tile's rows, `pixel_slices`, from the host's shapes
//     alone: enough blocks to reach about TARGET_BLOCKS). Nothing is read
//     on the host: a block whose slots start at or past its tile's cnt
//     writes zero rows and exits, and a warp whose 32 slots do skips the
//     math (its rows come out zero).
//   - Sums in a fixed order at every level: per lane over a row's pixels,
//     over the slice's rows in order, the slices' partials added in slice
//     order through shared memory by the first slice's warp, the 4 lanes
//     that share a slot by a fixed butterfly. No atomics: two launches give
//     the same bits. Nothing is cut off; the exp flushes results below
//     2^-126 to 0.
//   - The 16 steps of a row run one to a loop turn: 161 registers a thread
//     and no spill, so three blocks fit on an SM (65 KB of shared memory
//     each). Two to a turn took 168 registers and a 4-byte spill, and was
//     1% slower at the 100k scene.
//
// What holds it above the bound (tools/ab_k8b.py's variants of this file,
// PERF.md): without the exp it is 7% faster, with one product of three 18%;
// the rest is the per-pair f32 and integer instructions (dx, the exponent,
// the three sums, the split of exp(e)) beside the 12 mma.sync of each
// step, as in K9b. Four pixel slices at the 100k scene
// (where the rule takes one) are 14% slower, one slice on the flagship's
// lists (where it takes four) 57% slower; the tile staged through two
// double-buffered pieces is 1-7% slower than the whole tile.
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows [px, py, conic_a,
// conic_b, conic_c, op, feats(8), 0, 0] (ops/sorted.pack_gdata gathered by
// the binner's slots; the slots past cnt are the dead row, op 0), 16-byte
// aligned; cnt (n_tiles,) int32; g8 (8, n_tiles*2048) f32, pixel l of tile
// t at column t*2048 + l (l = row*128 + col), 16-byte aligned; cap a
// multiple of 512. Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TH = 16;             // tile height (rows)
constexpr int TWC = 128;           // tile width (columns)
constexpr int TPS = TH * TWC;      // pixels per tile
constexpr int NBS = 512;           // cap % NBS == 0
constexpr int GD = 16;             // floats per slot row
constexpr int FEAT = 8;            // cotangent rows
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 2;              // 16-slot mma tiles per warp
constexpr int WS = 16 * MT;        // slots per warp
constexpr int NG = 2 * MT;         // slots per lane
constexpr int PIECE = 512;         // pixels per staged piece
constexpr int PIECES = TPS / PIECE;
constexpr int NBUF = 4;            // pieces resident at once: the whole tile
constexpr int STRIDE = PIECE + 8;  // floats per staged feature row: lanes
                                   // (g, t) reading row t, pixel g hit 32 banks
constexpr int MAX_SLICES = WARPS;  // pixel slices per tile
constexpr long TARGET_BLOCKS = 2048;
constexpr int PART = 6 * NG + 4 * MT;   // partial sums a lane hands over
constexpr size_t SMEM = NBUF * FEAT * STRIDE * sizeof(float);   // 66,560 B
constexpr float LOG2E = 1.4426950408889634f;

static_assert(PART * 32 * (MAX_SLICES - 1) <= NBUF * FEAT * STRIDE,
              "the slices' partials fit in the stage");

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src));
}

// Per lane: slots G = 2m + h of its warp's two 16-row tiles m (h = 0: row
// g, h = 1: row g + 8, g = lane / 4), off(G) slots after the lane's first.
__device__ __forceinline__ int off(int G) {
  return 16 * (G >> 1) + 8 * (G & 1);
}

struct Lane {
  const float* rows;                  // slot G's row: rows + off(G) * GD
  float px[NG], ah[NG];               // px, -a/2 times log2(e)
  float bdy[NG], cdy2[NG];            // this row's terms
  float s0[NG], s1[NG], s2[NG];       // this row's sums of v, v dx, v dx^2
  float m0[NG], mdx[NG], mdy[NG], mxx[NG], mxy[NG], myy[NG];   // totals
  uint32_t fb[MT][4], fs[MT][4];                    // feats as A, split
  float racc[MT][4], gfeat[MT][4];                  // g_feat: row, total
};

// One step of 8 pixels at column l of the staged row s (8 feature rows of
// STRIDE); xa is the x centre of the lane's pixel 2t of the step.
__device__ __forceinline__ void step(Lane& L, const float* __restrict__ s,
                                     int l, float xa, int g, int t) {
  // g_w's B: rows t, t+4 (features), column g (pixel g); g_feat's B: rows
  // 2t, 2t+1 (pixels as k = t, t+4), column g (feature g).
  const float b1a = s[t * STRIDE + l + g];
  const float b1b = s[(t + 4) * STRIDE + l + g];
  const float2 b2 = *reinterpret_cast<const float2*>(s + g * STRIDE + l
                                                     + 2 * t);
  uint32_t p1b0, p1b1, p1s0, p1s1, p2b0, p2b1, p2s0, p2s1;
  split(b1a, p1b0, p1s0);
  split(b1b, p1b1, p1s1);
  split(b2.x, p2b0, p2s0);
  split(b2.y, p2b1, p2s1);
  const float xs[2] = {xa, xa + 1.f};
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float gw[4] = {0.f, 0.f, 0.f, 0.f};   // (g, 2t), (g, 2t+1), (g+8, ...)
    mma3(gw, L.fb[m], L.fs[m], p1b0, p1b1, p1s0, p1s1);
    float ex[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int G = 2 * m + (i >> 1);
      const float dx = xs[i & 1] - L.px[G];
      ex[i] = ex2(fmaf(dx, fmaf(L.ah[G], dx, L.bdy[G]), L.cdy2[G]));
      const float v = ex[i] * gw[i];      // g_e / op
      L.s0[G] += v;
      const float u = v * dx;
      L.s1[G] += u;
      L.s2[G] = fmaf(u, dx, L.s2[G]);
    }
    // A of g_feat / op: (g, k=t) = exp(e)(g, 2t), (g+8, t), (g, t+4) =
    // exp(e)(g, 2t+1), (g+8, t+4).
    uint32_t ab[4], as[4];
    split(ex[0], ab[0], as[0]);
    split(ex[2], ab[1], as[1]);
    split(ex[1], ab[2], as[2]);
    split(ex[3], ab[3], as[3]);
    mma3(L.racc[m], ab, as, p2b0, p2b1, p2s0, p2s1);
  }
}

// One tile row at y, staged at s: its 16 steps, then the row's sums into
// the running totals. py, b and c are read again for each row (from L1),
// which keeps the lane within 168 registers.
__device__ __forceinline__ void row_pass(Lane& L, const float* __restrict__ s,
                                         float x0, float y, int g, int t) {
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const float* r = L.rows + off(G) * GD;
    const float dy = y - r[1];
    L.bdy[G] = (-LOG2E * r[3]) * dy;
    L.cdy2[G] = ((-0.5f * LOG2E * r[4]) * dy) * dy;
    L.s0[G] = L.s1[G] = L.s2[G] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) L.racc[m][i] = 0.f;
#pragma unroll 1
  for (int l = 0; l < TWC; l += 8)
    step(L, s, l, x0 + static_cast<float>(l), g, t);
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const float dy = y - L.rows[off(G) * GD + 1];
    L.m0[G] += L.s0[G];
    L.mdx[G] += L.s1[G];
    L.mxx[G] += L.s2[G];
    L.mdy[G] = fmaf(dy, L.s0[G], L.mdy[G]);
    L.mxy[G] = fmaf(dy, L.s1[G], L.mxy[G]);
    L.myy[G] = fmaf(dy * dy, L.s0[G], L.myy[G]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) L.gfeat[m][i] += L.racc[m][i];
}

// fn(k, x) for each of a lane's partial sums x, k = 0 .. PART-1 in a fixed
// order: the six moments of each slot G, then g_feat.
template <typename F>
__device__ __forceinline__ void each_part(Lane& L, F&& fn) {
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    fn(6 * G, L.m0[G]);
    fn(6 * G + 1, L.mdx[G]);
    fn(6 * G + 2, L.mdy[G]);
    fn(6 * G + 3, L.mxx[G]);
    fn(6 * G + 4, L.mxy[G]);
    fn(6 * G + 5, L.myy[G]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) fn(6 * NG + 4 * m + i, L.gfeat[m][i]);
}

// Pixel slices per tile for these shapes: the fewest (1, 2 or 4) with which
// the grid holds about TARGET_BLOCKS blocks.
int pixel_slices(int n_tiles, int cap) {
  const long blocks = static_cast<long>(n_tiles) * (cap / (WS * WARPS));
  int slices = 1;
  while (slices < MAX_SLICES && blocks * slices < TARGET_BLOCKS) slices *= 2;
  return slices;
}

__global__ void __launch_bounds__(THREADS, 3)
binned_bwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt, const float* __restrict__ g8,
                  float* __restrict__ out, int tiles_x, int n_tiles, int cap,
                  int slices) {
  extern __shared__ __align__(16) float stage[];   // [NBUF][FEAT][STRIDE]

  const int tile = blockIdx.x;
  const int groups = WARPS / slices;          // slot groups of the block
  const int start = blockIdx.y * WS * groups;
  const int n_live = min(max(cnt[tile], 0), cap);
  if (start >= n_live) {                      // uniform in the block
    float4* dst = reinterpret_cast<float4*>(
        out + (static_cast<size_t>(tile) * cap + start) * GD);
    for (int k = threadIdx.x; k < WS * groups * GD / 4; k += THREADS)
      dst[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = warp / groups, sg = warp % groups;   // slice, slot group
  const int first = start + WS * sg;          // the warp's first slot
  const bool live = first < n_live;
  const size_t base = static_cast<size_t>(tile) * cap + first;

  // The tile's cotangent, piece k holding, for each slice q', the k-th
  // quarter of its rows: staged column j is pixel q' * (TPS / slices) +
  // k * sub + j % sub of the tile, q' = j / sub.
  const int sub = PIECE / slices;
  const float* gt = g8 + static_cast<size_t>(tile) * TPS;
  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  auto issue = [&](int k) {
    float* dst = stage + (k % NBUF) * FEAT * STRIDE;
    for (int c = threadIdx.x; c < FEAT * PIECE / 4; c += THREADS) {
      const int f = c / (PIECE / 4), j = 4 * (c % (PIECE / 4));
      const int qs = j / sub;
      cp_async16(dst + f * STRIDE + j,
                 gt + f * plane + qs * (TPS / slices) + k * sub + j - qs * sub);
    }
  };
#pragma unroll
  for (int k = 0; k < NBUF - 1; ++k) {
    if (k < PIECES) issue(k);
    asm volatile("cp.async.commit_group;");
  }

  Lane L;
  L.rows = gdense + (base + g) * GD;
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const float* r = L.rows + off(G) * GD;
    L.px[G] = r[0];
    L.ah[G] = -0.5f * LOG2E * r[2];
    L.m0[G] = L.mdx[G] = L.mdy[G] = L.mxx[G] = L.mxy[G] = L.myy[G] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* r0 = gdense + (base + 16 * m + g) * GD;
    const float* r1 = r0 + 8 * GD;
    // A of g_w: (g, f=t), (g+8, t), (g, t+4), (g+8, t+4).
    const float a[4] = {r0[6 + t], r1[6 + t], r0[10 + t], r1[10 + t]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(a[i], L.fb[m][i], L.fs[m][i]);
      L.gfeat[m][i] = 0.f;
    }
  }

  const float x0 = static_cast<float>((tile % tiles_x) * TWC + 2 * t) + 0.5f;
  const int y0 = (tile / tiles_x) * TH;
  const int rows = sub / TWC;                 // the slice's rows a piece
#pragma unroll 1
  for (int k = 0; k < PIECES; ++k) {
    if (k + NBUF - 1 < PIECES) issue(k + NBUF - 1);
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group %0;" :: "n"(NBUF - 1));
    __syncthreads();   // piece k has landed, every thread's part of it
    if (live) {
      const float* s = stage + (k % NBUF) * FEAT * STRIDE + q * sub;
#pragma unroll 1
      for (int r = 0; r < rows; ++r)
        row_pass(L, s + r * TWC, x0,
                 static_cast<float>(y0 + q * (TH / slices) + k * rows + r)
                 + 0.5f, g, t);
    }
    if (k + NBUF < PIECES) __syncthreads();   // its buffer is refilled next
  }

  // The slices' partials, added in slice order by slice 0's warp.
  asm volatile("cp.async.wait_group 0;");
  if (slices > 1) {
    __syncthreads();   // every read of the stage is over
    if (q > 0) {       // slices 1.. hand over, slot group by slot group
      float* p = stage + (warp - groups) * PART * 32 + lane;
      each_part(L, [&](int k, float& x) { p[k * 32] = x; });
    }
    __syncthreads();
    if (q > 0) return;
    for (int qs = 1; qs < slices; ++qs) {
      const float* p = stage + ((qs - 1) * groups + sg) * PART * 32 + lane;
      each_part(L, [&](int k, float& x) { x += p[k * 32]; });
    }
  }

  // The 4 lanes of a slot (t = 0..3) add their moments: lanes t and t^1,
  // then pairs; every lane ends with the same bits.
  auto lanes_sum = [](float& x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
  };
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    lanes_sum(L.m0[G]);
    lanes_sum(L.mdx[G]);
    lanes_sum(L.mdy[G]);
    lanes_sum(L.mxx[G]);
    lanes_sum(L.mxy[G]);
    lanes_sum(L.myy[G]);
  }
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const int m = G >> 1, h = G & 1;
    const size_t slot = base + 16 * m + 8 * h + g;
    float* dst = out + slot * GD;
    const float op = gdense[slot * GD + 5];
    if (t == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(
          op * L.mdx[G], op * L.mdy[G], op * L.mxx[G], op * L.mxy[G]);
    } else if (t == 1) {
      *reinterpret_cast<float2*>(dst + 4) =
          make_float2(op * L.myy[G], op * L.m0[G]);
    } else if (t == 3) {
      *reinterpret_cast<float2*>(dst + 14) = make_float2(0.f, 0.f);
    }
    // g_feat (slot row 8h + g, features 2t and 2t+1).
    *reinterpret_cast<float2*>(dst + 6 + 2 * t) =
        make_float2(op * L.gfeat[m][2 * h], op * L.gfeat[m][2 * h + 1]);
  }
}

}  // namespace

// The pixel slices the launcher splits each tile into for these shapes.
extern "C" int binned_bwd_pixel_slices(int n_tiles, int cap) {
  return pixel_slices(n_tiles, cap);
}

extern "C" cudaError_t binned_bwd_launch(const float* gdense, const int* cnt,
                                         const float* g8, float* out,
                                         int tiles_x, int n_tiles, int cap,
                                         cudaStream_t stream) {
  if (n_tiles <= 0 || tiles_x <= 0 || cap <= 0 || cap % NBS)
    return cudaErrorInvalidValue;
  // Opt in to > 48 KB of shared memory. The attribute belongs to the
  // current device, so it is set on every launch, not once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      binned_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  const int slices = pixel_slices(n_tiles, cap);
  binned_bwd_kernel<<<dim3(n_tiles, cap / (WS * (WARPS / slices))), THREADS,
                      SMEM, stream>>>(gdense, cnt, g8, out, tiles_x, n_tiles,
                                      cap, slices);
  return cudaGetLastError();
}

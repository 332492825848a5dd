// General-conic accumulation over a (pixel tile x gaussian block) grid,
// forward (K9a).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_fwd_kernel,
// launched there by _fwd_call: the dense EWA route above the sizes at which
// the band kernels' gaussian data (K5, splat_v2_fwd.cu) fit the TPU's VMEM.
// Per tile i of tp pixels of the row-major frame (pixels i*tp ..., centres at
// +0.5) and per block j of nb gaussians with mask[i, j] set, in block order:
//
//   e = -0.5 (a dx^2 + 2 b dx dy + c dy^2)      (the conic unscaled)
//   acc[f, p] += feats_f * op * exp(e)            (feats not pre-multiplied)
//
// and writes acc (8, n_tiles*tp). No cutoff: the mask holds every block whose
// conservative y-extent (weight >= 1e-14) reaches the tile. The TPU kernel
// skips a (tile, block) grid step whose mask bit is clear; so does this one,
// on the same mask, unpacked (one byte per pair). Pixels past the frame in
// the last tile are computed as the TPU kernel computes them (rows below the
// frame), not masked.
//
// Bound. Per (gaussian, pixel) pair of the active (tile, block) pairs the
// function needs the 8-wide product feats op . w (16 flops, which the TPU
// runs on its matrix unit as a bf16x3 product), one exp, and the exponent
// (5 flops with the row terms b dy and c dy^2 paid once per row and op
// folded into the feature rows); against 64 B read per gaussian, the mask
// read once and 32 B written per pixel. On this card the product goes to
// the tensor cores, so the exp on the SFU (16 per SM and clock) bounds the
// kernel, above the 5 flops at the f32 rate, the product's 3 x 16 TF32
// flops and far above the bytes. What holds this design above that bound
// (tools/ab_k9a.py --ablations, tools/pipe_rates.py): the issue of the
// per-pair f32 and integer instructions (dx, the exponent, the split of
// w), and mma.sync and ex2, whose pipes contend on this card.
//
// Design. A block of 4 warps owns 512 pixels of one tile (tp / 512 blocks a
// tile, rounded up; a warp past the tile's end only stages), a warp 128
// consecutive pixels as eight 16-pixel tiles of mma.sync.m16n8k8, and the
// block walks its tile's mask row in block order, staging the rows of each
// active block 128 at a time:
//   - The feature product runs on the tensor cores in TF32: A is w = exp(e)
//     (16 pixels x 8 gaussians), B the feature rows times op (8 gaussians x
//     8 features), D the pixels' 8 sums. Each operand is split 3 ways so
//     that the product keeps near-f32 accuracy: x = big + small with big
//     the TF32 part of x (the low 13 mantissa bits cleared) and small the
//     exact remainder, and big.big' + big.small' + small.big' (each term
//     off by at most about 2^-20 of |x x'|; the TPU kernel's bf16x3
//     _dot_pair(exact=True)). Lane (g, t) evaluates w in A's own fragment
//     layout, pixels g and g+8 and gaussians t and t+4: four exps per
//     product, none evaluated twice, no shuffle.
//   - op, log2(e) and the split of B are paid once per gaussian, when its
//     row is staged: a 128-row chunk lands in shared memory by cp.async, the
//     block turns it into per-lane B fragments (one 16-byte load a lane and
//     step) and conic rows (px, py and -a/2, -b, -c/2 times log2(e); three
//     broadcast loads), and w is one ex2.approx per pair. Each 8-gaussian
//     step is reused over the warp's eight pixel tiles.
//   - A warp whose 128 pixels lie in one frame row (every warp when the
//     width is a multiple of 128) pays dy, b dy and c dy^2 once per
//     gaussian and step; one that straddles rows pays them per pixel.
//   - The next chunk's copy (possibly of the next active block) is issued
//     once this chunk is turned, so it overlaps this chunk's math.
//   - Sums in two levels, in a fixed order: each chunk of 128 rows in the
//     mma accumulator (48 tensor-core additions, so its rounding stays near
//     f32's), then the chunk partials into the pixel's running f32 total in
//     chunk order, hence block order. A pixel of a 1M-gaussian scene sums
//     some 10^5 terms; a single running f32 sum was 1e-5 of it off. No
//     atomics: two launches give the same bits. The exp flushes results
//     below 2^-126 to 0.
//   - At most 168 registers a thread, so three blocks fit on an SM (four
//     spilled at 128 and ran slower).
//
// Inputs: mask (n_tiles, n_blocks) uint8; gdata (n_blocks*nb, 16) f32 rows
// [px, py, a, b, c, op, feats(8), 0, 0], 16-byte aligned; nb and tp
// multiples of 128, tp at most 2048. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 128;             // tp % THREADS == 0
constexpr int MT = 8;                    // 16-pixel mma tiles per warp
constexpr int WARP_PX = 16 * MT;         // 128 pixels per warp
constexpr int BLOCK_PX = THREADS / 32 * WARP_PX;   // 512 pixels per block
constexpr int GD = 16;                   // floats per gaussian row
constexpr int FEAT = 8;                  // output rows
constexpr int CHUNK = 128;      // rows staged at a time; nb % CHUNK == 0
constexpr int STEPS = CHUNK / 8;         // 8-gaussian mma steps per chunk
constexpr float LOG2E = 1.4426950408889634f;

// A chunk as cp.async lands it, and turned for the lanes: B fragments
// (bb(t, g), bb(t+4, g), bs(t, g), bs(t+4, g) for lane g*4 + t: gaussian,
// feature) and per t the conic of gaussians t and t+4 of each step.
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

// Thread i turns raw row i of the chunk: step i / 8, gaussian k = i % 8 of
// the step, which lanes with t = k % 4 read in half k / 4 of their operands.
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

// One staged chunk into d (zeroed by the caller) for the lane's pixels p0 +
// 16 m + 8 h + g. ROW: they lie in one frame row, at y, and pixel (m, h) at
// x0 + 16 m + 8 h; else each pixel's centre is found here.
template <bool ROW>
__device__ __forceinline__ void chunk(const Stage& S, float (&d)[MT][4],
                                      float x0, float y, int p0, int width,
                                      int lane) {
  const int t = lane & 3;
  float xs[MT][2], ys[MT][2];
  if (!ROW) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 16 * m + 8 * h + (lane >> 2);
        xs[m][h] = static_cast<float>(p % width) + 0.5f;
        ys[m][h] = static_cast<float>(p / width) + 0.5f;
      }
  }
#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    const float4 b = S.bf[s][lane];
    const float4 cx = S.cx[s][t];
    const float4 cy = S.cy[s][t];
    const float2 cc = S.cc[s][t];
    const float px[2] = {cx.x, cx.y}, ah[2] = {cx.z, cx.w};
    const float py[2] = {cy.x, cy.y}, bh[2] = {cy.z, cy.w};
    const float ch[2] = {cc.x, cc.y};
    float bdy[2], cdy2[2];
    if (ROW) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dy = y - py[j];
        bdy[j] = bh[j] * dy;
        cdy2[j] = (ch[j] * dy) * dy;
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // A: (g, k=t), (g+8, t), (g, t+4), (g+8, t+4): pixel half i & 1,
      // gaussian i >> 1.
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, j = i >> 1;
        float e;
        if (ROW) {
          const float dx = (x0 + static_cast<float>(16 * m + 8 * h)) - px[j];
          e = fmaf(dx, fmaf(ah[j], dx, bdy[j]), cdy2[j]);
        } else {
          const float dx = xs[m][h] - px[j];
          const float dy = ys[m][h] - py[j];
          e = fmaf(dx, fmaf(ah[j], dx, bh[j] * dy), (ch[j] * dy) * dy);
        }
        split(ex2(e), ab[i], as[i]);
      }
      mma3(d[m], ab, as, __float_as_uint(b.x), __float_as_uint(b.y),
           __float_as_uint(b.z), __float_as_uint(b.w));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 3)
splat_v1_fwd_kernel(const unsigned char* __restrict__ mask,
                    const float* __restrict__ gdata, float* __restrict__ out,
                    int n_blocks, int width, int nb, int tp, int hw_pad) {
  __shared__ __align__(16) Stage S;

  const int per_tile = (tp + BLOCK_PX - 1) / BLOCK_PX;
  const int tile = blockIdx.x / per_tile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off = (blockIdx.x % per_tile) * BLOCK_PX
                  + (threadIdx.x >> 5) * WARP_PX;
  const bool live = off < tp;            // uniform in the warp
  const int p0 = tile * tp + off;        // the warp's first pixel
  const int row0 = p0 / width;
  const bool row = row0 == (p0 + WARP_PX - 1) / width;
  const float x0 = static_cast<float>(p0 - row0 * width + g) + 0.5f;
  const float y0 = static_cast<float>(row0) + 0.5f;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;

  // The chunk sequence: the chunks of each block whose mask bit is set, in
  // block order; chunk c holds rows [c*CHUNK, (c+1)*CHUNK).
  const unsigned char* mrow = mask + static_cast<size_t>(tile) * n_blocks;
  const int per_block = nb / CHUNK;
  const int end = n_blocks * per_block;
  auto next = [&](int c) {
    ++c;
    if (c % per_block == 0) {
      int j = c / per_block;
      while (j < n_blocks && !mrow[j]) ++j;
      c = j * per_block;
    }
    return c;
  };
  auto issue = [&](int c) {
    const float* src = gdata + static_cast<size_t>(c) * CHUNK * GD;
    for (int k = threadIdx.x; k < CHUNK * GD / 4; k += THREADS)
      cp_async16(&S.raw[k], src + 4 * k);
  };

  int c = next(-1);
  if (c < end) issue(c);
  asm volatile("cp.async.commit_group;");
  while (c < end) {
    const int cn = next(c);
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();   // the chunk has landed; the last chunk's math is over
    turn(S, threadIdx.x);
    __syncthreads();   // turned; the raw buffer is free
    if (cn < end) issue(cn);
    asm volatile("cp.async.commit_group;");
    if (live) {
      float d[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[m][i] = 0.f;
      if (row)
        chunk<true>(S, d, x0, y0, p0, width, lane);
      else
        chunk<false>(S, d, x0, y0, p0, width, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][i] += d[m][i];
    }
    c = cn;
  }

  if (!live) return;
  // D's layout: (pixel g, feature 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t p = static_cast<size_t>(p0 + 16 * m + 8 * (i >> 1) + g);
      out[static_cast<size_t>(2 * t + (i & 1)) * hw_pad + p] = acc[m][i];
    }
}

}  // namespace

extern "C" cudaError_t splat_v1_fwd_launch(const unsigned char* mask,
                                           const float* gdata, float* out,
                                           int n_tiles, int n_blocks,
                                           int width, int nb, int tp,
                                           cudaStream_t stream) {
  if (n_tiles <= 0 || n_blocks <= 0 || width <= 0 || nb <= 0
      || nb % CHUNK || tp <= 0 || tp % THREADS || tp > 2048)
    return cudaErrorInvalidValue;
  const int per_tile = (tp + BLOCK_PX - 1) / BLOCK_PX;
  splat_v1_fwd_kernel<<<n_tiles * per_tile, THREADS, 0, stream>>>(
      mask, gdata, out, n_blocks, width, nb, tp, n_tiles * tp);
  return cudaGetLastError();
}

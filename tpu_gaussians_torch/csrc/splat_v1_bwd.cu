// General-conic accumulation over a (pixel tile x gaussian block) grid,
// backward (K9b).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_bwd_kernel,
// launched there by _bwd_call. Given the cotangent g8 (8, n_tiles*tp) of
// K9a's output (splat_v1_fwd.cu), for each gaussian of block j and each tile
// i with mask[i, j] set (pixels i*tp ..., centres at +0.5), with e and
// w = op exp(e) as in K9a:
//
//   g_w = sum_f g8[f, p] feats_f,   g_e = w g_w
//   g_px = sum g_e (a dx + b dy),   g_py = sum g_e (b dx + c dy)
//   g_a = -sum g_e dx^2 / 2, g_b = -sum g_e dx dy, g_c = -sum g_e dy^2 / 2
//   g_op = sum exp(e) g_w,          g_feat_f = sum_p g8[f, p] w
//
// summed over every pixel of those tiles, and writes the gaussian's row
// [g_px, g_py, g_a, g_b, g_c, g_op, g_feat(8), 0, 0] of out (n_pad, 16): the
// gradients themselves, no post-pass. Rows of blocks that no tile's mask
// holds are zero.
//
// Bound. Per (gaussian, pixel) pair of the active (tile, block) pairs the
// function needs the two 8-wide products g_w = feats . g8 and g_feat +=
// g8 w (32 flops, which the TPU runs on its matrix unit), one exp, and the
// elementwise terms around them (11 flops with the row terms hoisted and op
// factored out). On this card the products go to the tensor cores, so the
// exp on the SFU (16 per SM and clock) bounds the kernel, above the 11
// flops at the f32 rate and far above the bytes (64 B per gaussian, 32 B
// per pixel).
//
// Design. CUDA blocks run concurrently and in no order, so the kernel is
// gaussian-major and deterministic without atomics: a block of 128 threads
// owns 128 gaussians of one nb-block and walks, in tile order, the tiles
// whose mask holds that block. Each warp owns 32 gaussians as two 16-row
// tiles of mma.sync.m16n8k8 and walks the tile's pixels 8 at a time:
//   - op factors out of every sum but g_op's: with v = exp(e) g_w (so
//     g_e = op v), the kernel sums v, v dx, ... and exp(e) g8, and
//     multiplies by op once at the end; g_op = sum v.
//   - g_w (16 gaussians x 8 pixels) is one TF32 product over the features,
//     and g_feat / op (16 gaussians x 8 features) one over the pixels, each
//     split 3 ways so that it keeps near-f32 accuracy: x = big + small with
//     big the TF32 part of x, and big.big' + big.small' + small.big' (each
//     term off by at most about 2^-20 of |x x'|; the TPU kernel's bf16x3
//     _dot_pair(exact=True) on the MXU). The first product's N column n is
//     pixel n of the 8, and the second product's K index k is pixel 2k for
//     k < 4 and 2(k-4)+1 above: the columns 2t, 2t+1 that lane (g, t) holds
//     of g_w are exactly the k = t, t+4 it needs of exp(e) as the A
//     operand, so no shuffle passes between the two products.
//   - The exponent uses ex2.approx with log2(e) folded into the conic, and
//     its row-constant terms (b dy, c dy^2) once per row segment: the pixels
//     of one frame row inside one staged piece. Per segment each lane sums
//     v, v dx and v dx^2 over its pixels, and adds them, times 1, dy and
//     dy^2, into its running moments at the end of the segment: sum v dy =
//     dy sum v, and so on.
//   - The tile's cotangent streams through shared memory in pieces of 512
//     pixels (8 x 520 floats, 16 KB), double-buffered with cp.async so that
//     the next piece's copy (possibly of the next active tile) overlaps this
//     piece's math; a block takes 33 KB of shared memory and at most 168
//     registers a thread, so three blocks fit on an SM.
//   - Sums in two levels, in a fixed order: the moments per row segment,
//     g_feat per tile (in the mma accumulator), each added into its
//     gaussian's running total in segment and tile order; the 4 lanes that
//     share a gaussian add their totals by a fixed butterfly at the end, and
//     the five moments become the conic's and the position's gradients once
//     (linear in them: g_px = op (a sum v dx + b sum v dy), ...). No
//     atomics: two launches give the same bits. Nothing is cut off; the exp
//     flushes results below 2^-126 to 0.
//
// Inputs: mask (n_tiles, n_blocks) uint8; gdata (n_blocks*nb, 16) f32 rows
// [px, py, a, b, c, op, feats(8), 0, 0]; g8 (8, n_tiles*tp) f32; nb and tp
// multiples of 128, tp at most 2048. Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int MT = 2;              // 16-gaussian mma tiles per warp
constexpr int THREADS = 128;
constexpr int KG = 16 * MT * THREADS / 32;   // gaussians per block: 128,
                                             // nb % KG == 0
constexpr int GD = 16;             // floats per gaussian row
constexpr int FEAT = 8;            // cotangent rows
constexpr int TP_MAX = 2048;       // largest tile
constexpr int PIECE = 512;         // pixels staged at a time; a tile's last
                                   // piece may be shorter (a multiple of 128)
constexpr int STRIDE = PIECE + 8;  // floats per staged feature row: lanes
                                   // (g, t) reading row t, pixel g hit 32 banks
constexpr float LOG2E = 1.4426950408889634f;

// x = big + small: big is x with the 13 low mantissa bits cleared (a TF32
// value: one logic instruction, where cvt.rna.tf32 takes several), small the
// exact f32 remainder (|small| < 2^-10 |x|), which the tensor core reads to
// TF32 precision.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
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

// Per lane: gaussians G = 2m + h of its warp's two 16-row tiles m (h = 0:
// row g, h = 1: row g + 8, g = lane / 4).
constexpr int NG = 2 * MT;         // gaussians per lane
struct Lane {
  float px[NG], py[NG];
  float ah[NG], bh[NG], ch[NG];       // -a/2, -b, -c/2 times log2(e)
  float bdy[NG], cdy2[NG];            // this segment's row terms
  float s0[NG], s1[NG], s2[NG];       // this segment's sums of v, v dx, v dx^2
  float m0[NG], mdx[NG], mdy[NG], mxx[NG], mxy[NG], myy[NG];   // totals
  uint32_t fb[MT][4], fs[MT][4];                    // feats as A, split
  float tacc[MT][4], gfeat[MT][4];                  // g_feat: tile, total
};

// One group of 8 pixels [q, q + 8) of a row segment that ends at q_end,
// staged at column l of s (8 rows of STRIDE). x0 is the x centre of the
// group's first pixel. MASKED: pixels at or past q_end belong to the next
// segment and count 0 here.
template <bool MASKED>
__device__ __forceinline__ void group(Lane& L, const float* __restrict__ s,
                                      int l, float x0, int q, int q_end,
                                      int g, int t) {
  // g_w's B: rows t, t+4 (features), column g (pixel g); g_feat's B: row
  // 2t, 2t+1 (pixels as k = t, t+4), column g (feature g).
  float b1a = s[t * STRIDE + l + g];
  float b1b = s[(t + 4) * STRIDE + l + g];
  float b2a = s[g * STRIDE + l + 2 * t];
  float b2b = s[g * STRIDE + l + 2 * t + 1];
  bool v0 = true, v1 = true;
  if (MASKED) {
    const bool vg = q + g < q_end;
    v0 = q + 2 * t < q_end;
    v1 = q + 2 * t + 1 < q_end;
    b1a = vg ? b1a : 0.f;
    b1b = vg ? b1b : 0.f;
    b2a = v0 ? b2a : 0.f;
    b2b = v1 ? b2b : 0.f;
  }
  uint32_t p1b0, p1b1, p1s0, p1s1, p2b0, p2b1, p2s0, p2s1;
  split(b1a, p1b0, p1s0);
  split(b1b, p1b1, p1s1);
  split(b2a, p2b0, p2s0);
  split(b2b, p2b1, p2s1);
  const float xa = x0 + static_cast<float>(2 * t);
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
      if (MASKED) ex[i] = ((i & 1) ? v1 : v0) ? ex[i] : 0.f;
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
    mma3(L.tacc[m], ab, as, p2b0, p2b1, p2s0, p2s1);
  }
}

__global__ void __launch_bounds__(THREADS, 3)
splat_v1_bwd_kernel(const unsigned char* __restrict__ mask,
                    const float* __restrict__ gdata,
                    const float* __restrict__ g8, float* __restrict__ out,
                    int n_tiles, int n_blocks, int width, int nb, int tp) {
  __shared__ __align__(16) float stage[2][FEAT * STRIDE];   // 33,280 B

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gbase = blockIdx.x * KG + warp * 16 * MT;   // the warp's rows
  const int blk = blockIdx.x * KG / nb;            // the nb-block of all 128
  const size_t hw_pad = static_cast<size_t>(n_tiles) * tp;

  Lane L;
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const float* r = gdata + static_cast<size_t>(
        gbase + 16 * (G >> 1) + 8 * (G & 1) + g) * GD;
    L.px[G] = r[0];
    L.py[G] = r[1];
    L.ah[G] = -0.5f * LOG2E * r[2];
    L.bh[G] = -LOG2E * r[3];
    L.ch[G] = -0.5f * LOG2E * r[4];
    L.m0[G] = L.mdx[G] = L.mdy[G] = L.mxx[G] = L.mxy[G] = L.myy[G] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* r0 = gdata + static_cast<size_t>(gbase + 16 * m + g) * GD;
    const float* r1 = r0 + 8 * GD;
    // A of g_w: (g, f=t), (g+8, t), (g, t+4), (g+8, t+4).
    const float a[4] = {r0[6 + t], r1[6 + t], r0[10 + t], r1[10 + t]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(a[i], L.fb[m][i], L.fs[m][i]);
      L.tacc[m][i] = L.gfeat[m][i] = 0.f;
    }
  }

  // The (tile, piece) sequence: pieces of PIECE pixels of each tile whose
  // mask holds this block, tiles in order.
  auto next_tile = [&](int tile) {
    do { ++tile; } while (tile < n_tiles
                          && !mask[static_cast<size_t>(tile) * n_blocks + blk]);
    return tile;
  };
  auto issue = [&](int tile, int off, int buf) {
    const int len = min(PIECE, tp - off);
    const int per_row = len / 4;          // 16-byte chunks per feature row
    const float* src = g8 + static_cast<size_t>(tile) * tp + off;
    for (int k = threadIdx.x; k < FEAT * per_row; k += THREADS) {
      const int f = k / per_row, c = k - f * per_row;
      cp_async16(&stage[buf][f * STRIDE + 4 * c], src + f * hw_pad + 4 * c);
    }
  };

  int tile = next_tile(-1), off = 0, buf = 0;
  if (tile < n_tiles) issue(tile, off, 0);
  asm volatile("cp.async.commit_group;");
  while (tile < n_tiles) {
    int ntile = tile, noff = off + PIECE;
    if (noff >= tp) { ntile = next_tile(tile); noff = 0; }
    if (ntile < n_tiles) issue(ntile, noff, buf ^ 1);
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group 1;");
    __syncthreads();   // this piece has landed, every thread's part of it

    const float* s = stage[buf];
    const int p0 = tile * tp + off;
    const int p_end = p0 + min(PIECE, tp - off);
    for (int q0 = p0; q0 < p_end;) {      // row segments of the piece
      const int row = q0 / width;
      const int q_end = min(p_end, (row + 1) * width);
      const float gy = static_cast<float>(row) + 0.5f;
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        const float dy = gy - L.py[G];
        L.bdy[G] = L.bh[G] * dy;
        L.cdy2[G] = (L.ch[G] * dy) * dy;
        L.s0[G] = L.s1[G] = L.s2[G] = 0.f;
      }
      const float x0 = static_cast<float>(q0 - row * width) + 0.5f;
      int q = q0;
#pragma unroll 2
      for (; q + 8 <= q_end; q += 8)
        group<false>(L, s, q - p0, x0 + static_cast<float>(q - q0), q, q_end,
                     g, t);
      if (q < q_end)
        group<true>(L, s, q - p0, x0 + static_cast<float>(q - q0), q, q_end,
                    g, t);
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        const float dy = gy - L.py[G];
        L.mdx[G] += L.s1[G];
        L.mdy[G] = fmaf(dy, L.s0[G], L.mdy[G]);
        L.mxx[G] += L.s2[G];
        L.mxy[G] = fmaf(dy, L.s1[G], L.mxy[G]);
        L.myy[G] = fmaf(dy * dy, L.s0[G], L.myy[G]);
        L.m0[G] += L.s0[G];
      }
      q0 = q_end;
    }
    if (ntile != tile) {                  // the tile's last piece
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          L.gfeat[m][i] += L.tacc[m][i];
          L.tacc[m][i] = 0.f;
        }
    }
    __syncthreads();   // every read of this buffer is over before its refill
    tile = ntile;
    off = noff;
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;");

  // The 4 lanes of a gaussian (t = 0..3) add their moments: lanes t and
  // t^1, then pairs; every lane ends with the same bits.
  auto lanes_sum = [](float& x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
  };
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    lanes_sum(L.mdx[G]);
    lanes_sum(L.mdy[G]);
    lanes_sum(L.mxx[G]);
    lanes_sum(L.mxy[G]);
    lanes_sum(L.myy[G]);
    lanes_sum(L.m0[G]);
  }
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const int m = G >> 1, h = G & 1;
    const size_t gi = static_cast<size_t>(gbase + 16 * m + 8 * h + g);
    float* dst = out + gi * GD;
    const float* r = gdata + gi * GD;
    const float op = r[5];
    if (t == 0) {
      const float a = r[2], b = r[3], c = r[4];
      *reinterpret_cast<float4*>(dst) = make_float4(
          op * fmaf(a, L.mdx[G], b * L.mdy[G]),
          op * fmaf(b, L.mdx[G], c * L.mdy[G]), -0.5f * op * L.mxx[G],
          -op * L.mxy[G]);
    } else if (t == 1) {
      *reinterpret_cast<float2*>(dst + 4) =
          make_float2(-0.5f * op * L.myy[G], L.m0[G]);
    } else if (t == 3) {
      *reinterpret_cast<float2*>(dst + 14) = make_float2(0.f, 0.f);
    }
    // g_feat (gaussian row 8h + g, features 2t and 2t+1).
    *reinterpret_cast<float2*>(dst + 6 + 2 * t) =
        make_float2(op * L.gfeat[m][2 * h], op * L.gfeat[m][2 * h + 1]);
  }
}

}  // namespace

extern "C" cudaError_t splat_v1_bwd_launch(const unsigned char* mask,
                                           const float* gdata,
                                           const float* g8, float* out,
                                           int n_tiles, int n_blocks,
                                           int width, int nb, int tp,
                                           cudaStream_t stream) {
  if (n_tiles <= 0 || n_blocks <= 0 || width <= 0 || nb <= 0 || nb % KG
      || tp <= 0 || tp % 128 || tp > TP_MAX)
    return cudaErrorInvalidValue;
  splat_v1_bwd_kernel<<<n_blocks * nb / KG, THREADS, 0, stream>>>(
      mask, gdata, g8, out, n_tiles, n_blocks, width, nb, tp);
  return cudaGetLastError();
}

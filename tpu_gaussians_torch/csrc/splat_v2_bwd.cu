// General-conic (EWA) band accumulation, backward (K6).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_bwd_kernel_v2,
// launched there by _bwd_call_v2. Given the cotangent g8 (8, n_bands*2048) of
// K5's output (splat_v2_fwd.cu), for each band i (pixels i*2048 ... of the
// row-major frame, centres at +0.5) and each gaussian of its block range
// [lo[i], lo[i] + cnt[i]) of nb gaussians, with the conic pre-scaled as in
// K5 (a' = -a/2, b' = -b, c' = -c/2) and featsop = feats * op:
//
//   x    = exp(dx (a' dx + b' dy) + c' dy^2)
//   g_x  = sum_f g8[f, p] featsop_f,   g_e = x g_x
//   Mdx = sum g_e dx, Mdy = sum g_e dy, Mxx = sum g_e dx^2,
//   Mxy = sum g_e dx dy, Myy = sum g_e dy^2,   g_featop_f = sum_p g8[f, p] x
//
// summed over every band whose range holds the gaussian, and writes its row
// [Mdx, Mdy, Mxx, Mxy, Myy, 0, g_featop(8), 0, 0] of out (n_pad, 16). Rows of
// blocks that no band reaches are zero. A row of zero opacity (padding, dead
// capacity) has featsop 0, so its moments are 0; its g_featop is the true
// derivative, as on the TPU (the post-pass multiplies it by op). No row or
// pair is skipped on its opacity.
//
// Bound. Per (gaussian, pixel) pair of the ranges' live rows the function
// needs the two 8-wide products g_x = featsop . g8 and g_featop += g8 x (32
// flops, which the TPU runs on its matrix unit), one exp, and the
// elementwise terms around them (11 flops with the row terms hoisted: the
// per-pair function of K9b, splat_v1_bwd.cu, with op folded into featsop);
// against 64 B read per gaussian, g8 (32 B per pixel) read once and 64 B
// written per gaussian. On this card the products go to the tensor cores,
// so the exp on the SFU (16 per SM and clock) bounds the kernel, above the
// 3 x 32 TF32 flops, the 11 flops at the f32 rate and far above the bytes.
//
// Design: K9b's inner loop over a band's gaussian range (K8b,
// binned_bwd.cu, runs it over a tile's slot list).
//   - CUDA blocks run concurrently and in no order, so the kernel is
//     gaussian-major and deterministic without atomics: a block of 4 warps
//     owns 128 gaussians of one nb-block and walks, in band order, the bands
//     whose range holds that block, found from lo and cnt as it goes (no
//     host read). A warp owns 32 gaussians as two 16-row tiles of
//     mma.sync.m16n8k8 and walks its pixels 8 at a time, row by row.
//   - Filling the card: each band's 2048 pixels are split into `slices`
//     slices of 2048 / slices consecutive pixels (blockIdx.y; whole frame
//     rows where the width divides them), the count from the host's shapes
//     alone (`pixel_slices`: the fewest, up to MAX_SLICES, that give the
//     grid BLOCKS_PER_SM blocks per SM). 16 at the flagship's 3,072
//     gaussians (384 blocks), 1 from 67,584 up. Each slice's rows go to a
//     scratch plane, and a second kernel adds the planes in slice order;
//     one slice writes out directly.
//   - g_x (16 gaussians x 8 pixels, K = features) and g_featop (16
//     gaussians x 8 features, K = pixels) are TF32 products, each split 3
//     ways so that it keeps near-f32 accuracy: x = big + small with big the
//     TF32 part of x (the low 13 mantissa bits cleared), and big.big' +
//     big.small' + small.big'. The second product's K index k is pixel 2k
//     for k < 4 and 2(k-4)+1 above: the columns 2t, 2t+1 that lane (g, t)
//     holds of g_x are exactly the k = t, t+4 it needs of x as A, so no
//     shuffle passes between the two products.
//   - The exponent is one ex2.approx with log2(e) folded into the conic (in
//     registers: gdata is K5's staging), and its row terms (b' dy, c' dy^2)
//     are paid once per row segment: the pixels of one frame row inside one
//     staged piece. Per segment each lane sums g_e, g_e dx and g_e dx^2 over
//     its pixels and folds them into its running moments at the segment's
//     end: Mdy += dy sum g_e, Myy += dy^2 sum g_e, Mxy += dy sum g_e dx. The
//     g_featop accumulator of the mma restarts every segment and is added
//     into an f32 total in segment order.
//   - The slice's part of each band's cotangent streams through shared
//     memory in pieces of up to PIECE pixels (8 x 264 floats), a ring of
//     NBUF buffers filled by cp.async NBUF - 1 pieces ahead (of the next
//     bands too), so that the copies land while earlier pieces are
//     computed.
//   - Sums in a fixed order at every level: per lane over a segment's
//     pixels, segments in order (bands in order), the 4 lanes of a gaussian
//     by a fixed butterfly, slices in slice order. No atomics: two launches
//     give the same bits. Nothing is cut off; the exp flushes results below
//     2^-126 to 0.
//   - Two steps of 8 pixels run to a loop turn: 152 registers a thread and
//     no spill, so three blocks fit on an SM (33.8 KB of shared memory
//     each).
//
// What holds it above the bound (tools/ab_k6.py's variants of this file,
// PERF.md): the per-step cost it shares with K8b and K9b, about 60 SM
// cycles per warp step of 8 pixels x 32 gaussians at the 100k scene, with
// no pipe full. Without the exp it is 0-3% faster, with one product of
// three 12-15%; more warps an SM are slower (launch bounds of four blocks:
// 128 registers, 2-25%; a warp per 16 gaussians, 8-15%). One slice is
// 6.5x slower on the flagship's 3,072 gaussians and 2.5x at 8,192, where
// the rule takes 16; 16 slices at 100k, where it takes one, are 4% slower.
//
// Inputs: lo, cnt (n_bands,) int32; gdata (n_pad, 16) f32 rows [px, py, a',
// b', c', op, featsop(8), 0, 0], n_pad a multiple of nb, nb of 128; g8
// (8, n_bands*2048) f32, 16-byte aligned; part (slices, n_pad, 16) f32
// scratch (`splat_v2_bwd_slices(n_pad)` slices; unused for one). Build: nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler
// -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TP2 = 2048;          // pixels per band
constexpr int GD = 16;             // floats per gaussian row
constexpr int FEAT = 8;            // cotangent rows
constexpr int THREADS = 128;
constexpr int MT = 2;              // 16-gaussian mma tiles per warp
constexpr int NG = 2 * MT;         // gaussians per lane
constexpr int KG = 16 * MT * THREADS / 32;   // gaussians per block: 128,
                                             // nb % KG == 0
constexpr int PIECE = 256;         // pixels staged at a time (a slice's last
                                   // piece of a band may be shorter)
constexpr int NBUF = 4;            // staged pieces in the ring
constexpr int STRIDE = PIECE + 8;  // floats per staged feature row: lanes
                                   // (g, t) reading row t, pixel g hit 32 banks
constexpr int MAX_SLICES = 16;     // slices of a band: 128 pixels at least
constexpr int BLOCKS_PER_SM = 4;   // the slice rule's target
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

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

// Per lane: gaussians G = 2m + h of its warp's two 16-row tiles m (h = 0:
// row g, h = 1: row g + 8, g = lane / 4), off(G) rows after the lane's
// first.
__device__ __forceinline__ int off(int G) {
  return 16 * (G >> 1) + 8 * (G & 1);
}

struct Lane {
  float px[NG], py[NG];
  float ah[NG], bh[NG], ch[NG];       // a', b', c' times log2(e)
  float bdy[NG], cdy2[NG];            // this segment's row terms
  float s0[NG], s1[NG], s2[NG];       // this segment's sums of g_e, g_e dx,
                                      // g_e dx^2
  float mdx[NG], mdy[NG], mxx[NG], mxy[NG], myy[NG];   // totals
  uint32_t fb[MT][4], fs[MT][4];                    // featsop as A, split
  float racc[MT][4], gfeat[MT][4];                  // g_featop: segment, total
};

// One group of 8 pixels [q, q + 8) of a row segment that ends at q_end,
// staged at column l of s (8 rows of STRIDE). x0 is the x centre of the
// group's first pixel. MASKED: pixels at or past q_end belong to the next
// segment and count 0 here.
template <bool MASKED>
__device__ __forceinline__ void group(Lane& L, const float* __restrict__ s,
                                      int l, float x0, int q, int q_end,
                                      int g, int t) {
  // g_x's B: rows t, t+4 (features), column g (pixel g); g_featop's B: rows
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
    float gx[4] = {0.f, 0.f, 0.f, 0.f};   // (g, 2t), (g, 2t+1), (g+8, ...)
    mma3(gx, L.fb[m], L.fs[m], p1b0, p1b1, p1s0, p1s1);
    float ex[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int G = 2 * m + (i >> 1);
      const float dx = xs[i & 1] - L.px[G];
      ex[i] = ex2(fmaf(dx, fmaf(L.ah[G], dx, L.bdy[G]), L.cdy2[G]));
      if (MASKED) ex[i] = ((i & 1) ? v1 : v0) ? ex[i] : 0.f;
      const float ge = ex[i] * gx[i];
      L.s0[G] += ge;
      const float u = ge * dx;
      L.s1[G] += u;
      L.s2[G] = fmaf(u, dx, L.s2[G]);
    }
    // A of g_featop: (g, k=t) = x(g, 2t), (g+8, t), (g, t+4) = x(g, 2t+1),
    // (g+8, t+4).
    uint32_t ab[4], as[4];
    split(ex[0], ab[0], as[0]);
    split(ex[2], ab[1], as[1]);
    split(ex[1], ab[2], as[2]);
    split(ex[3], ab[3], as[3]);
    mma3(L.racc[m], ab, as, p2b0, p2b1, p2s0, p2s1);
  }
}

// Pixel slices per band for these shapes: the fewest (1, 2, 4, ...,
// MAX_SLICES) with which the grid of n_pad / KG gaussian blocks holds
// BLOCKS_PER_SM blocks per SM.
int pixel_slices(int n_pad, int sms) {
  const long blocks = n_pad / KG;
  int slices = 1;
  while (slices < MAX_SLICES
         && blocks * slices < static_cast<long>(BLOCKS_PER_SM) * sms)
    slices *= 2;
  return slices;
}

// The current device's SM count, 0 if it cannot be read.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess)
    return 0;
  return sms;
}

__global__ void __launch_bounds__(THREADS, 3)
splat_v2_bwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                    const float* __restrict__ gdata,
                    const float* __restrict__ g8, float* __restrict__ rows,
                    int n_bands, int width, int nb, int n_pad, int slices) {
  __shared__ __align__(16) float stage[NBUF][FEAT * STRIDE];   // 33,792 B

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int gbase = blockIdx.x * KG + warp * 16 * MT;   // the warp's rows
  const int blk = blockIdx.x * KG / nb;            // the nb-block of all 128
  const int slice = blockIdx.y;
  const int len = TP2 / slices;                    // a band's pixels here
  const size_t hw_pad = static_cast<size_t>(n_bands) * TP2;

  Lane L;
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const float* r = gdata + static_cast<size_t>(gbase + g + off(G)) * GD;
    L.px[G] = r[0];
    L.py[G] = r[1];
    L.ah[G] = LOG2E * r[2];
    L.bh[G] = LOG2E * r[3];
    L.ch[G] = LOG2E * r[4];
    L.mdx[G] = L.mdy[G] = L.mxx[G] = L.mxy[G] = L.myy[G] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* r0 = gdata + static_cast<size_t>(gbase + 16 * m + g) * GD;
    const float* r1 = r0 + 8 * GD;
    // A of g_x: (g, f=t), (g+8, t), (g, t+4), (g+8, t+4).
    const float a[4] = {r0[6 + t], r1[6 + t], r0[10 + t], r1[10 + t]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(a[i], L.fb[m][i], L.fs[m][i]);
      L.gfeat[m][i] = 0.f;
    }
  }

  // The (band, piece) sequence: pieces of up to PIECE pixels of this slice
  // of each band whose range holds this block, bands in order. Every thread
  // walks it alike, so the control flow is uniform in the block.
  auto next_band = [&](int band) {
    do { ++band; } while (band < n_bands
                          && (blk < lo[band] || blk >= lo[band] + cnt[band]));
    return band;
  };
  const int first = next_band(-1);
  int ib = first, ioff = 0;               // the next piece to stage
  auto issue_next = [&](int buf) {
    if (ib < n_bands) {
      const int n4 = min(PIECE, len - ioff) / 4;   // 16-byte chunks a row
      const float* src = g8 + static_cast<size_t>(ib) * TP2
                         + slice * len + ioff;
      for (int k = threadIdx.x; k < FEAT * n4; k += THREADS) {
        const int f = k / n4, c = k - f * n4;
        cp_async16(&stage[buf][f * STRIDE + 4 * c], src + f * hw_pad + 4 * c);
      }
      ioff += PIECE;
      if (ioff >= len) { ioff = 0; ib = next_band(ib); }
    }
    asm volatile("cp.async.commit_group;");
  };
#pragma unroll
  for (int k = 0; k < NBUF - 1; ++k) issue_next(k);

  int band = first, poff = 0, buf = 0;
  while (band < n_bands) {
    issue_next((buf + NBUF - 1) % NBUF);   // the buffer read last turn
    asm volatile("cp.async.wait_group %0;" :: "n"(NBUF - 1));
    __syncthreads();   // this piece has landed, every thread's part of it

    const float* s = stage[buf];
    const int p0 = band * TP2 + slice * len + poff;
    const int p_end = p0 + min(PIECE, len - poff);
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
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) L.racc[m][i] = 0.f;
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
        L.mxx[G] += L.s2[G];
        L.mdy[G] = fmaf(dy, L.s0[G], L.mdy[G]);
        L.mxy[G] = fmaf(dy, L.s1[G], L.mxy[G]);
        L.myy[G] = fmaf(dy * dy, L.s0[G], L.myy[G]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) L.gfeat[m][i] += L.racc[m][i];
      q0 = q_end;
    }
    poff += PIECE;
    if (poff >= len) { poff = 0; band = next_band(band); }
    __syncthreads();   // every read of this buffer is over before its refill
    buf = (buf + 1) % NBUF;
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
  }
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const int m = G >> 1, h = G & 1;
    float* dst = rows + (static_cast<size_t>(slice) * n_pad + gbase + g
                         + off(G)) * GD;
    if (t == 0) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(L.mdx[G], L.mdy[G], L.mxx[G], L.mxy[G]);
    } else if (t == 1) {
      *reinterpret_cast<float2*>(dst + 4) = make_float2(L.myy[G], 0.f);
    } else if (t == 3) {
      *reinterpret_cast<float2*>(dst + 14) = make_float2(0.f, 0.f);
    }
    // g_featop (gaussian row 8h + g, features 2t and 2t+1).
    *reinterpret_cast<float2*>(dst + 6 + 2 * t) =
        make_float2(L.gfeat[m][2 * h], L.gfeat[m][2 * h + 1]);
  }
}

// out[i] = sum over slices s = 0 .. slices-1, in that order, of part[s][i]
// (one float4 of a row per thread).
__global__ void __launch_bounds__(RED_THREADS)
segment_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                   int n4, int slices) {
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

// The pixel slices the launcher splits each band into for n_pad gaussians
// on the current device (the leading dimension of part), or -1 if the
// device's SM count cannot be read.
extern "C" int splat_v2_bwd_slices(int n_pad) {
  const int sms = sm_count();
  return sms > 0 ? pixel_slices(n_pad, sms) : -1;
}

extern "C" cudaError_t splat_v2_bwd_launch(const int* lo, const int* cnt,
                                           const float* gdata, const float* g8,
                                           float* part, float* out,
                                           int n_bands, int width, int nb,
                                           int n_pad, cudaStream_t stream) {
  if (n_bands <= 0 || width <= 0 || nb <= 0 || nb % KG || n_pad <= 0
      || n_pad % nb)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int slices = pixel_slices(n_pad, sms);
  splat_v2_bwd_kernel<<<dim3(n_pad / KG, slices), THREADS, 0, stream>>>(
      lo, cnt, gdata, g8, slices == 1 ? out : part, n_bands, width, nb, n_pad,
      slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const int n4 = n_pad * (GD / 4);
  segment_sum_kernel<<<(n4 + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0,
                       stream>>>(reinterpret_cast<const float4*>(part),
                                 reinterpret_cast<float4*>(out), n4, slices);
  return cudaGetLastError();
}

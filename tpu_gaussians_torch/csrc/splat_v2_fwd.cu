// General-conic (EWA) band accumulation, forward (K5).
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/splat.py:_fwd_kernel_v2,
// launched there by _fwd_call_v2. Per 2048-pixel band i of the row-major
// frame (pixels i*2048 ... ; centres at +0.5), over the gaussian blocks
// [lo[i], lo[i] + cnt[i]) of nb gaussians:
//
//   e = dx (a' dx + b' dy) + c' dy^2        (conic pre-scaled: a' = -a/2, ...)
//   acc[f, p] += featsop_f * exp(e)          (featsop = feats * op)
//
// and writes acc (8, n_bands*2048), every element: the padded pixels of the
// last band (computed as rows below the frame, as the TPU kernel computes
// them), and zeros for a band whose range is empty. No cutoff: a band's
// range holds every block whose conservative y-extent (weight >= 1e-14)
// reaches it.
//
// Bound. Per (gaussian, pixel) pair of the ranges' live rows the function
// needs the 8-wide product featsop . exp(e) (16 flops, which the TPU runs
// on its matrix unit), one exp, and the exponent (5 flops with the row
// terms b' dy and c' dy^2 paid once per row); against 64 B read per
// gaussian and 32 B written per pixel: K9a's per-pair function
// (splat_v1_fwd.cu) with op already folded into the rows. On this card the
// product goes to the tensor cores, so the exp on the SFU (16 per SM and
// clock) bounds the kernel, above the 5 flops at the f32 rate, the
// product's 3 x 16 TF32 flops and far above the bytes.
//
// What holds it above that bound (tools/ab_k5.py's variants of this file,
// PERF.md): from 8,192 to 500k gaussians on 512x512 it runs at 48-60% of
// it, as K9a does on the same inputs; without the exp it is 15-17%
// faster, with one product of three 12-13%: the issue of the per-pair f32
// and integer work beside the two pipes. On the flagship's 128x128 views
// it is latency-bound (15-26%): one wave of blocks of one or two chunks,
// each chunk's copy waited for, and the second pass (15% of a launch).
//
// Design: K9a's per-pair work over a band's gaussian range, the range split
// across blocks (K1's split-K, splat_sep_fwd.cu) so that every scene fills
// the card.
//   - A block of 4 warps owns 512 pixels of one band (4 blocks a band), a
//     warp 128 consecutive pixels as eight 16-pixel tiles of
//     mma.sync.m16n8k8, and walks its slice of the band's range 128 rows
//     (a chunk) at a time.
//   - The feature product runs on the tensor cores in TF32: A is x =
//     exp(e) (16 pixels x 8 gaussians), B the featsop rows (8 gaussians x
//     8 features), D the pixels' 8 sums. Each operand is split 3 ways so
//     that the product keeps near-f32 accuracy: x = big + small with big
//     the TF32 part of x (the low 13 mantissa bits cleared) and small the
//     exact remainder, and big.big' + big.small' + small.big'. Lane (g, t)
//     evaluates x in A's own fragment layout, pixels g and g+8 and
//     gaussians t and t+4: four exps per product, none evaluated twice, no
//     shuffle.
//   - log2(e) and the split of B are paid once per gaussian, when its row
//     is staged: a chunk lands in shared memory by cp.async, the block
//     turns it into per-lane B fragments (one 16-byte load a lane and
//     step) and conic rows (px, py and a', b', c' times log2(e), folded
//     here and not in the staging, which K6 reads as it is; three
//     broadcast loads), and x is one ex2.approx per pair. Each 8-gaussian
//     step is reused over the warp's eight pixel tiles.
//   - A warp whose 128 pixels lie in one frame row (every warp when the
//     width is a multiple of 128) pays dy, b' dy and c' dy^2 once per
//     gaussian and step; one that straddles rows (widths 200 and 960) pays
//     them per pixel.
//   - A chunk whose 128 rows all have featsop 0 (dead capacity rows, which
//     a fit keeps at one screen point, so the y-sort puts them side by side
//     inside the ranges; padding rows) is skipped, on the barrier that
//     ends its turn. Such a row's terms are exactly 0 for a finite exp, so
//     every sum keeps its bits.
//   - The next chunk's copy is issued once this chunk is turned, so it
//     overlaps this chunk's math. Ranges are whole nb-blocks and nb is a
//     multiple of 128, so every chunk is full.
//   - Filling the card: each band's range is dealt to `slices` slices
//     chunk by chunk (slice s takes chunks s, s + slices, ...), the count
//     from the host's shapes alone (`band_slices`: the fewest of 1, 2, 4,
//     ..., MAX_SLICES, at most n_pad / 128, that give the grid of n_bands
//     x 4 blocks TARGET_PER_SM blocks per SM, two waves at three blocks an
//     SM, then as few as hold a range of n_pad rows in as many turns): on
//     132 SMs 12 at the flagship's 8 bands of n_pad 3072 (384 blocks, one
//     wave), 2 at the 512x512 frames' 128 bands, 1 from 198 bands (the
//     960x540 frame's 254). Each band's own range is dealt, so a band's
//     slices hold equal work whatever its length, and the host reads no
//     range. Dealt and not cut, a run of skipped chunks spreads over the
//     slices: cut into consecutive pieces, the flagship's slices met its
//     dead run unevenly, and the SMs that the block order gave the heavy
//     slices ran long. Slices vary fastest in the grid, so a band's
//     slices start together (with slices last, the second half of a long
//     range waited for a later wave). A block whose slice holds no chunk
//     exits at once; slice 0 always writes (zeros for an empty band).
//     Each slice writes its partial plane, and a second kernel adds a
//     band's live slices in slice order; with one slice the block writes
//     acc itself.
//   - Sums in three levels, in a fixed order: each chunk in the mma
//     accumulator (restarted every chunk: 48 tensor-core additions, so its
//     rounding stays near f32's), the chunk partials into the slice's
//     running f32 total in chunk order, then the slices in slice order. A
//     pixel of a 1M-gaussian scene sums some 10^5 terms; a single running
//     f32 sum was 1e-5 of it off. No atomics: two launches give the same
//     bits. The exp flushes results below 2^-126 to 0.
//   - At most 168 registers a thread, so three blocks fit on an SM (K9a's
//     finding: four spilled at 128 and ran slower); 18.5 KB of shared
//     memory a block.
//
// Inputs: lo, cnt (n_bands,) int32; gdata (n_pad, 16) f32 rows [px, py, a',
// b', c', op, featsop(8), 0, 0], 16-byte aligned, n_pad a multiple of nb,
// nb of 128; part (slices, 8, n_bands*2048) f32 scratch
// (`splat_v2_fwd_slices(n_bands, n_pad)` slices; unused for one). Build:
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TP2 = 2048;                // pixels per band
constexpr int THREADS = 128;
constexpr int MT = 8;                    // 16-pixel mma tiles per warp
constexpr int WARP_PX = 16 * MT;         // 128 pixels per warp
constexpr int BLOCK_PX = THREADS / 32 * WARP_PX;   // 512 pixels per block
constexpr int BLOCKS_PER_BAND = TP2 / BLOCK_PX;
constexpr int GD = 16;                   // floats per gaussian row
constexpr int FEAT = 8;                  // output rows
constexpr int CHUNK = 128;      // rows staged at a time; nb % CHUNK == 0
constexpr int STEPS = CHUNK / 8;         // 8-gaussian mma steps per chunk
constexpr int MAX_SLICES = 16;           // slices of a band's range
constexpr int TARGET_PER_SM = 6;         // the slice rule's blocks per SM
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// A chunk as cp.async lands it, and turned for the lanes: B fragments
// (bb(t, g), bb(t+4, g), bs(t, g), bs(t+4, g) for lane g*4 + t: gaussian,
// feature) and per t the conic of gaussians t and t+4 of each step.
struct Stage {
  float4 raw[CHUNK * GD / 4];            // 8 KB
  float4 bf[STEPS][32];                  // 8 KB
  float4 cx[STEPS][4];                   // px, px', a', a''      (x log2 e)
  float4 cy[STEPS][4];                   // py, py', b', b''
  float2 cc[STEPS][4];                   // c', c''
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
// Returns whether the row's featsop is nonzero.
__device__ __forceinline__ bool turn(Stage& S, int i) {
  const float4 h0 = S.raw[4 * i];        // px, py, a', b'
  const float4 h1 = S.raw[4 * i + 1];    // c', op, f0, f1
  const float4 h2 = S.raw[4 * i + 2];    // f2 .. f5
  const float4 h3 = S.raw[4 * i + 3];    // f6, f7, 0, 0
  const int s = i >> 3, k = i & 7, tq = k & 3, hi = k >> 2;
  float* cx = reinterpret_cast<float*>(&S.cx[s][tq]);
  float* cy = reinterpret_cast<float*>(&S.cy[s][tq]);
  float* cc = reinterpret_cast<float*>(&S.cc[s][tq]);
  cx[hi] = h0.x;
  cx[2 + hi] = LOG2E * h0.z;
  cy[hi] = h0.y;
  cy[2 + hi] = LOG2E * h0.w;
  cc[hi] = LOG2E * h1.x;
  const float f[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};
#pragma unroll
  for (int n = 0; n < FEAT; ++n) {
    uint32_t big, small;
    split(f[n], big, small);
    float* b = reinterpret_cast<float*>(&S.bf[s][n * 4 + tq]);
    b[hi] = __uint_as_float(big);
    b[2 + hi] = __uint_as_float(small);
  }
  return f[0] != 0.f || f[1] != 0.f || f[2] != 0.f || f[3] != 0.f
         || f[4] != 0.f || f[5] != 0.f || f[6] != 0.f || f[7] != 0.f;
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

// Slices of each band's range for these shapes: the fewest (1, 2, 4, ...,
// MAX_SLICES, and at most n_pad / CHUNK: no range holds more chunks) with
// which the grid of n_bands x BLOCKS_PER_BAND blocks per slice holds
// TARGET_PER_SM blocks per SM, then trimmed to the fewest that deal a range
// of n_pad rows in as many turns: 12 of 16 for 24 chunks, 2 turns each.
int band_slices(int n_bands, int n_pad, int sms) {
  const long blocks = static_cast<long>(n_bands) * BLOCKS_PER_BAND;
  const int chunks = n_pad / CHUNK;      // the most a range can hold
  int slices = 1;
  while (slices < MAX_SLICES && 2 * slices <= chunks
         && blocks * slices < static_cast<long>(TARGET_PER_SM) * sms)
    slices *= 2;
  // No more slices than a full range fills at ceil(chunks / slices) chunks
  // each: 12 of 16 for 24 chunks.
  const int per = (chunks + slices - 1) / slices;
  return (chunks + per - 1) / per;
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

// The live slices of a band whose range holds cnt_blocks nb-blocks: those
// that hold a chunk, and at least slice 0 (which writes even an empty band).
__device__ __forceinline__ int live_slices(int cnt_blocks, int nb,
                                           int slices) {
  return max(1, min(slices, cnt_blocks * (nb / CHUNK)));
}

__global__ void __launch_bounds__(THREADS, 3)
splat_v2_fwd_kernel(const int* __restrict__ lo, const int* __restrict__ cnt,
                    const float* __restrict__ gdata, float* __restrict__ part,
                    int width, int nb, int hw_pad, int slices) {
  __shared__ __align__(16) Stage S;

  // Slices vary fastest in the grid: a band's slices start together.
  const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int band = tile / BLOCKS_PER_BAND;
  if (slice >= live_slices(cnt[band], nb, slices)) return;   // no chunk
  // The slice's chunks: c0, c0 + slices, ... below c1.
  const int c0 = lo[band] * (nb / CHUNK) + slice;
  const int c1 = (lo[band] + cnt[band]) * (nb / CHUNK);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int p0 = band * TP2 + (tile % BLOCKS_PER_BAND) * BLOCK_PX
                 + (threadIdx.x >> 5) * WARP_PX;   // the warp's first pixel
  const int row0 = p0 / width;
  const bool row = row0 == (p0 + WARP_PX - 1) / width;
  const float x0 = static_cast<float>(p0 - row0 * width + g) + 0.5f;
  const float y0 = static_cast<float>(row0) + 0.5f;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;

  auto issue = [&](int c) {              // rows [c*CHUNK, (c+1)*CHUNK)
    const float* src = gdata + static_cast<size_t>(c) * CHUNK * GD;
    for (int k = threadIdx.x; k < CHUNK * GD / 4; k += THREADS)
      cp_async16(&S.raw[k], src + 4 * k);
  };
  if (c0 < c1) issue(c0);
  asm volatile("cp.async.commit_group;");
  for (int c = c0; c < c1; c += slices) {
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();   // the chunk has landed; the last chunk's math is over
    // Turned, the raw buffer free; and whether any row of the chunk has a
    // nonzero featsop.
    const bool live = __syncthreads_or(turn(S, threadIdx.x));
    if (c + slices < c1) issue(c + slices);
    asm volatile("cp.async.commit_group;");
    if (!live) continue;                 // every term of the chunk is 0
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

  // D's layout: (pixel g, feature 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
  float* out = part + static_cast<size_t>(slice) * FEAT * hw_pad;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t p = static_cast<size_t>(p0 + 16 * m + 8 * (i >> 1) + g);
      out[static_cast<size_t>(2 * t + (i & 1)) * hw_pad + p] = acc[m][i];
    }
}

// out = each band's live slice planes summed in slice order, one float4 (4
// pixels of one band) a thread.
__global__ void __launch_bounds__(RED_THREADS)
splat_v2_fwd_sum_kernel(const int* __restrict__ cnt,
                        const float4* __restrict__ part,
                        float4* __restrict__ out, int nb, int hw_pad,
                        int slices) {
  const int n4 = FEAT * hw_pad / 4;
  const int i = blockIdx.x * RED_THREADS + threadIdx.x;
  if (i >= n4) return;
  const int band = (i % (hw_pad / 4)) / (TP2 / 4);
  const int live = live_slices(cnt[band], nb, slices);
  float4 s = part[i];
  for (int k = 1; k < live; ++k) {
    const float4 p = part[static_cast<size_t>(k) * n4 + i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  out[i] = s;
}

}  // namespace

// The slices the launcher splits each band's range into for these shapes
// on the current device (the leading dimension of part), or -1 if the
// device's SM count cannot be read.
extern "C" int splat_v2_fwd_slices(int n_bands, int n_pad) {
  const int sms = sm_count();
  return sms > 0 ? band_slices(n_bands, n_pad, sms) : -1;
}

extern "C" cudaError_t splat_v2_fwd_launch(const int* lo, const int* cnt,
                                           const float* gdata, float* part,
                                           float* out, int n_bands,
                                           int width, int nb, int n_pad,
                                           cudaStream_t stream) {
  if (n_bands <= 0 || width <= 0 || nb <= 0 || nb % CHUNK || n_pad <= 0
      || n_pad % nb)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int slices = band_slices(n_bands, n_pad, sms);
  const int hw_pad = n_bands * TP2;
  splat_v2_fwd_kernel<<<n_bands * BLOCKS_PER_BAND * slices, THREADS, 0,
                        stream>>>(lo, cnt, gdata, slices == 1 ? out : part,
                                  width, nb, hw_pad, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const int n4 = FEAT * hw_pad / 4;
  splat_v2_fwd_sum_kernel<<<(n4 + RED_THREADS - 1) / RED_THREADS,
                            RED_THREADS, 0, stream>>>(
      cnt, reinterpret_cast<const float4*>(part),
      reinterpret_cast<float4*>(out), nb, hw_pad, slices);
  return cudaGetLastError();
}

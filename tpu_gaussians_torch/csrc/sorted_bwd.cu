// Depth-sorted front-to-back compositing over per-tile slot lists, backward.
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/sorted.py:_sorted_bwd_kernel,
// launched there by _sorted_bwd_call. For C = sum_i T_i a_i f_i per pixel and
// feature (T_i the transmittance before slot i in the tile's depth order, a_i
// its clamped alpha, f_i its features [r, g, b, 1, z, ...]) and the cotangent
// g8 of the forward's output acc, it recomputes the forward in slot order and
// writes, per slot, the row
//
//   [Mdx, Mdy, Mxx, Mxy, Myy, M0, g_feat(8), 0, 0]          (summed over pixels)
//
//   gf = f_i . g8,  P_i = sum_{j<=i} T_j a_j gf_j,  ctg = acc . g8
//   g_a = T_i gf - (ctg - P_i) / (1 - a_i)
//   g_e = a_i g_a where 1e-5 <= a_raw <= 0.9999, else 0
//   M0 = sum g_e, Mdx = sum g_e dx, Mxx = sum g_e dx^2, Mdy, Myy likewise,
//   Mxy = sum g_e dx dy (0 for the axis footprint), g_feat = sum T_i a_i g8.
//
// S_i = ctg - P_i is the part of C.g8 behind slot i, so the pass runs front to
// back like the forward. It takes the forward's exit decisions instead of
// deciding again: tile t processes exactly the slots of its first
// chunks_done[t] 512-slot chunks (what sorted_fwd.cu composited), and T, a_raw
// and the clamp are computed with sorted_fwd.cu's expressions, so that T_i and
// ctg belong to the acc being differentiated. Rows of other slots are zero.
//
// Bound: f32 ALU work, 66 operations (60 for the axis footprint) and one exp
// per (slot, pixel) composited, counted from the pixel loop below, against
// 64 B read and written per slot and 64 B read per pixel (acc, g8). Most
// composited (slot, pixel) pairs lie outside the slot's 1e-5 ellipse, where
// the pixel loop adds exact zeros: the culling below skips them.
//
// Design. The walk over a tile's slots is sequential per pixel (T and P carry
// from slot to slot), but pixels are independent. So each 16x128 tile is
// split over a thread-block cluster of S = 8 blocks (the portable cluster
// size) on neighbouring SMs: block r owns tile rows 2r and 2r+1, and each of
// its 128 threads one column of those two rows (so the dx moments factor out
// of the pixel loop: Mdx = dx sum g_e, ...), with its pixels' g8, ctg, T and
// P in registers. The grid has 8 blocks per tile where one block per tile
// left all but a few SMs idle on small frames, and each slot's critical path
// is 2 pixels long instead of 8. Slot rows stream through shared memory 64
// at a time. Per slot, each thread sums its pixels' 14 terms, a
// reduce-scatter over the warp's lanes (16 shuffles, all indices fixed at
// compile time so the values stay in registers) leaves each warp's 16
// partial sums in shared memory, and after each pass of 64 slots the block
// adds its 4 warps' rows in warp order into a block row per slot. After one
// cluster barrier, block r adds the 8 blocks' rows of slots 8r ... 8r+7 of
// the pass, in cluster-rank order, read through distributed shared memory,
// and writes them as whole rows. The block rows are double-buffered, so one
// barrier per pass suffices. The division by 1 - a (at least 1e-4) is
// __fdividef, 2 ulp. No atomics in the rows and no global scratch: two
// launches give the same bits.
//
// Culling, exact, by sorted_fwd.cu's rule (K3's): where a_raw < 1e-5 at
// all of a warp's pixels, its pass over the slot adds 0 to every sum, adds
// 0 to P and multiplies T by 1, and its partial row is +-0. As each pass is
// staged, thread s bounds slot s with K3's extents (warp_mask, a copy of
// K3's: |dy| <= sqrt(Q a / det) + 1, |dx| <= sqrt(Q c / det) + 1, Q = 1.01
// (2 ln(op / 1e-5) + 1e-4), conics that are not positive definite, thinner
// than det >= 2e-3 a c, or not finite never culled). A slot whose y-extent
// misses the block's two rows is listed for none of its warps, one whose
// x-extent misses a warp's 32 columns not for that warp. Each warp lists
// its slots of the pass in slot order (two ballots) and walks the list
// with no branch, pixel loop and reduce-scatter alike; the block sum adds
// the warps' rows that were listed, in warp order, to +0. So every row is
// the unculled kernel's, but for the sign of a zero. kernels/sorted_fwd.
// slot_extent and cull_blocks mirror the rule on the CPU. The walk is
// unrolled 4 deep: the next slots' rows and exps overlap this one's chain
// of T and P (on the H100, 4% less time than 2 deep on the fit cell's
// 1080p view, and the flagship's few large gaussians back at the unculled
// kernel's time). What is left is issue-bound: some 250 instructions a
// walked (slot, warp), a quarter of them the reduce-scatter; skipping it
// where a listed warp's a_s is 0 at every pixel saved nothing.
//
// Counter: given a non-null `walks`, each block adds, with one atomic
// each after its last pass, the walks its warps' lists held ((slot, warp)
// pairs) to walks[0] and the unculled kernel's (composited slots x 4
// warps) to walks[1]; with a null one it does no more than before.
//
// Inputs: gdense (n_tiles*cap, 16) f32 rows [px, py, conic_a, conic_b,
// conic_c, op, f(8), 0, 0]; cnt, chunks_done (n_tiles,) int32; acc, g8
// (8, n_tiles*2048) f32, pixel l of tile t at column t*2048 + l; walks
// (2,) int64 or null. Output out (n_tiles*cap, 16) f32. Build: nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler
// -fPIC.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 16;           // tile height (rows)
constexpr int TWC = 128;         // tile width (columns)
constexpr int TPS = TH * TWC;    // pixels per tile
constexpr int NBS = 512;         // slots per chunk (the forward's exit step)
constexpr int GD = 16;           // floats per slot row
constexpr int FEAT = 8;          // feature rows of acc and g8
constexpr int S = 8;             // blocks per tile: one cluster
constexpr int PPT = TH / S;      // pixels (rows of one column) per thread: 2
constexpr int THREADS = TWC;     // a thread per column
constexpr int WARPS = THREADS / 32;
constexpr int SB = 64;           // slots staged per pass
constexpr int SR = SB / S;       // slots of a pass each block finishes
constexpr bool CULL = true;      // list the slots by their extents
constexpr bool ROW_CULL = true;  // ... by their y-extents too
constexpr int ALL_WARPS = (1 << 4) - 1;
constexpr float ALPHA_CUTOFF = 1e-5f;
constexpr float A_MAX = 0.9999f;
constexpr float Q_SLACK = 1e-4f;       // the extent's slack in Q, added
constexpr float Q_SCALE = 1.01f;       // and then as a factor
constexpr float MIN_DET_RATIO = 2e-3f; // thinner conics are never culled
constexpr float MARGIN_PX = 1.f;       // the extent's margin in pixels

static_assert(SR * GD / 4 <= THREADS, "one float4 of finished rows a thread");
static_assert(SB == 64 && SB <= THREADS, "two ballots list a pass");
static_assert(WARPS == 4, "a mask bit per warp");

// sorted_fwd.cu's warp_mask, letter for letter (a test holds the two
// copies equal): the warps (bit w: columns 32w ... 32w + 31) of the block
// whose rows have centres ylo ... yhi that evaluate the slot with row
// h0 = [px, py, a, b], h1 = [c, op, ...]; xt is the tile's first column.
// The rule is kernels/sorted_fwd.slot_extent's.
template <bool AXIS>
__device__ __forceinline__ int warp_mask(float4 h0, float4 h1, int xt,
                                         float ylo, float yhi) {
  if (!CULL) return ALL_WARPS;
  const float px = h0.x, py = h0.y, a = h0.z, b = AXIS ? 0.f : h0.w;
  const float c = h1.x, op = h1.y;
  const float ac = a * c;
  const float det = __fsub_rn(ac, __fmul_rn(b, b));   // as the mirror: no fma
  const bool cullable = isfinite(px) && isfinite(py) && isfinite(a) &&
                        isfinite(b) && isfinite(c) && isfinite(op) &&
                        isfinite(ac) && a > 0.f && c > 0.f && det > 0.f &&
                        det >= MIN_DET_RATIO * ac;
  if (!cullable) return ALL_WARPS;
  if (!(op > 0.f)) return 0;
  const float q = 2.f * logf(op / ALPHA_CUTOFF) + Q_SLACK;
  if (!(q > 0.f)) return 0;
  const float qe = q * Q_SCALE;
  const float ex = sqrtf(qe * c / det) + MARGIN_PX;
  const float ey = sqrtf(qe * a / det) + MARGIN_PX;
  if (ROW_CULL && !(py - ey <= yhi && py + ey >= ylo)) return 0;
  int mask = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float xl = static_cast<float>(xt + 32 * w) + 0.5f;
    const float xh = static_cast<float>(xt + 32 * w + 31) + 0.5f;
    if (px - ex <= xh && px + ex >= xl) mask |= 1 << w;
  }
  return mask;
}

// One step of warp_reduce_scatter16: lanes with bit BIT set keep the upper
// HALF of the values still held and send the lower half to the partner lane,
// the others the reverse; each adds what it receives.
template <int HALF, int BIT>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[16], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float lo = v[k], hi = v[k + HALF];
    v[k] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, BIT);
  }
}

// On return lane l holds the sum over the warp's 32 lanes of v[(l >> 1) & 15]
// (v is clobbered): 8 + 4 + 2 + 1 + 1 shuffles.
__device__ __forceinline__ float warp_reduce_scatter16(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
  reduce_scatter_step<8, 16>(v, lane);
  reduce_scatter_step<4, 8>(v, lane);
  reduce_scatter_step<2, 4>(v, lane);
  reduce_scatter_step<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <bool AXIS>
__global__ void __cluster_dims__(S, 1, 1) __launch_bounds__(THREADS)
sorted_bwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt,
                  const float* __restrict__ acc,
                  const float* __restrict__ g8,
                  const int* __restrict__ chunks_done,
                  float* __restrict__ out,
                  unsigned long long* __restrict__ walks,
                  int tiles_x, int n_tiles, int cap) {
  __shared__ float4 rows[SB * GD / 4];             // 4 KB: staged slot rows
  __shared__ float4 part4[WARPS * SB * GD / 4];    // 16 KB: warp partial rows
  __shared__ float4 bpart[2][SB * GD / 4];         // 8 KB: block rows, 2 passes
  __shared__ unsigned char smask[SB];              // the slots' warp masks
  __shared__ unsigned char list[WARPS][SB];        // each warp's listed slots
  __shared__ unsigned long long listed[WARPS];     // ... as bits
  __shared__ int walked[WARPS];                    // list lengths, summed
  float* part = reinterpret_cast<float*>(part4);   // [WARPS][SB][16]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = threadIdx.x;
  const int row0 = PPT * rank;               // rows row0, row0 + 1
  const int xt = (tile % tiles_x) * TWC;
  const float gx = static_cast<float>(xt + col) + 0.5f;
  const int gy0 = (tile / tiles_x) * TH + row0;
  const float ylo = static_cast<float>(gy0) + 0.5f;
  const float yhi = static_cast<float>(gy0 + PPT - 1) + 0.5f;

  // Per pixel: the cotangent, ctg = acc . g8, T and the prefix P.
  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  const size_t pix0 = static_cast<size_t>(tile) * TPS + row0 * TWC + col;
  float gr[PPT][FEAT], ctg[PPT], T[PPT], P[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const size_t p = pix0 + i * TWC;
    ctg[i] = 0.f;
#pragma unroll
    for (int f = 0; f < FEAT; ++f) {
      gr[i][f] = g8[f * plane + p];
      ctg[i] += acc[f * plane + p] * gr[i][f];
    }
    T[i] = 1.f;
    P[i] = 0.f;
  }

  const int n_slots = min(min(cnt[tile], cap), chunks_done[tile] * NBS);
  const float4* src = reinterpret_cast<const float4*>(
      gdense + static_cast<size_t>(tile) * cap * GD);
  float4* dst = reinterpret_cast<float4*>(
      out + static_cast<size_t>(tile) * cap * GD);

  int buf = 0;
  int n_walked = 0;          // the walks of this warp's lists
  for (int base = 0; base < n_slots; base += SB, buf ^= 1) {
    const int m = min(SB, n_slots - base);
    // The previous pass's reads of rows, part, smask and listed are over.
    __syncthreads();
    for (int k = threadIdx.x; k < m * (GD / 4); k += THREADS)
      rows[k] = src[static_cast<size_t>(base) * (GD / 4) + k];
    if (threadIdx.x < SB) {
      const int s = threadIdx.x;
      const float4* h = src + static_cast<size_t>(base + s) * (GD / 4);
      smask[s] = s < m ? warp_mask<AXIS>(h[0], h[1], xt, ylo, yhi) : 0;
    }
    __syncthreads();

    // This warp's list: slots lane and lane + 32 where its bit is set.
    const bool in0 = (smask[lane] >> warp) & 1;
    const bool in1 = (smask[lane + 32] >> warp) & 1;
    const unsigned lo = __ballot_sync(0xffffffffu, in0);
    const unsigned hi = __ballot_sync(0xffffffffu, in1);
    const unsigned below = (1u << lane) - 1u;
    if (in0) list[warp][__popc(lo & below)] = lane;
    if (in1) list[warp][__popc(lo) + __popc(hi & below)] = lane + 32;
    if (lane == 0)
      listed[warp] = lo | (static_cast<unsigned long long>(hi) << 32);
    const int n_list = __popc(lo) + __popc(hi);
    n_walked += n_list;
    __syncwarp();

    // Walk the listed slots in order: every slot left out has a_raw under
    // the cutoff at all of this warp's pixels.
#pragma unroll 4
    for (int j = 0; j < n_list; ++j) {
      const int s = list[warp][j];
      const float4 h0 = rows[s * 4 + 0];    // px, py, a, b
      const float4 h1 = rows[s * 4 + 1];    // c, op, f0, f1
      const float4 h2 = rows[s * 4 + 2];    // f2, f3, f4, f5
      const float4 h3 = rows[s * 4 + 3];    // f6, f7, 0, 0
      const float fe[FEAT] = {h1.z, h1.w, h2.x, h2.y, h2.z, h2.w, h3.x, h3.y};
      const float dx = gx - h0.x;
      const float ex = AXIS ? expf(-0.5f * h0.z * (dx * dx)) : 0.f;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;   // sum g_e, g_e dy, g_e dy^2
      float gfe[FEAT];
#pragma unroll
      for (int f = 0; f < FEAT; ++f) gfe[f] = 0.f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dy = static_cast<float>(gy0 + i) + 0.5f - h0.y;
        float a_raw;
        if (AXIS) {
          a_raw = (h1.y * expf(-0.5f * h1.x * (dy * dy))) * ex;
        } else {
          a_raw = h1.y * expf(-0.5f * (h0.z * dx * dx + 2.f * h0.w * dx * dy
                                       + h1.x * dy * dy));
        }
        const float a_s = a_raw < ALPHA_CUTOFF ? 0.f : fminf(a_raw, A_MAX);
        const float w = T[i] * a_s;
        float gf = 0.f;
#pragma unroll
        for (int f = 0; f < FEAT; ++f) gf += fe[f] * gr[i][f];
        P[i] += w * gf;
        if (a_raw >= ALPHA_CUTOFF && a_raw <= A_MAX) {
          const float g_e =
              a_s * (T[i] * gf - __fdividef(ctg[i] - P[i], 1.f - a_s));
          s0 += g_e;
          s1 += g_e * dy;
          s2 += g_e * dy * dy;
        }
#pragma unroll
        for (int f = 0; f < FEAT; ++f) gfe[f] += w * gr[i][f];
        T[i] *= 1.f - a_s;
      }
      float v[16] = {dx * s0, s1, dx * dx * s0, AXIS ? 0.f : dx * s1, s2, s0,
                     gfe[0], gfe[1], gfe[2], gfe[3], gfe[4], gfe[5], gfe[6],
                     gfe[7], 0.f, 0.f};
      const float total = warp_reduce_scatter16(v);
      if ((lane & 1) == 0)
        part[(warp * SB + s) * GD + ((lane >> 1) & 15)] = total;
    }
    __syncthreads();

    // The block's row of each slot: its listing warps' partials in warp
    // order (an unlisted warp's is +-0).
    for (int k = threadIdx.x; k < m * (GD / 4); k += THREADS) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (!((listed[w] >> (k >> 2)) & 1)) continue;
        const float4 p = part4[w * SB * (GD / 4) + k];
        sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
      }
      bpart[buf][k] = sum;
    }
    // Every block's rows of this pass are written; the other buffer's reads
    // (the pass before) are over in every block.
    cluster.sync();

    // Slots rank*SR ... of the pass: the S blocks' rows in rank order.
    const int r = rank * SR + (threadIdx.x >> 2), q = threadIdx.x & 3;
    if (threadIdx.x < SR * (GD / 4) && r < m) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int b = 0; b < S; ++b) {
        const float4 p = cluster.map_shared_rank(&bpart[buf][0], b)[r * 4 + q];
        sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
      }
      dst[static_cast<size_t>(base + r) * 4 + q] = sum;
    }
  }
  if (lane == 0) walked[warp] = n_walked;
  // No block leaves while another may still read its shared memory.
  cluster.sync();
  if (walks != nullptr && threadIdx.x == 0 && n_slots > 0) {
    atomicAdd(&walks[0], static_cast<unsigned long long>(
        walked[0] + walked[1] + walked[2] + walked[3]));
    atomicAdd(&walks[1], static_cast<unsigned long long>(n_slots) * WARPS);
  }

  // Slots the forward did not composite: past cnt, or in chunks after the exit.
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = n_slots * 4 + rank * THREADS + threadIdx.x; k < cap * 4;
       k += S * THREADS)
    dst[k] = zero;
}

}  // namespace

extern "C" cudaError_t sorted_bwd_launch(const float* gdense, const int* cnt,
                                         const float* acc, const float* g8,
                                         const int* chunks_done, float* out,
                                         long long* walks, int tiles_x,
                                         int n_tiles, int cap, int axis,
                                         cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const int blocks = n_tiles * S;   // a cluster of S blocks per tile
  auto* w = reinterpret_cast<unsigned long long*>(walks);
  if (axis) {
    sorted_bwd_kernel<true><<<blocks, THREADS, 0, stream>>>(
        gdense, cnt, acc, g8, chunks_done, out, w, tiles_x, n_tiles, cap);
  } else {
    sorted_bwd_kernel<false><<<blocks, THREADS, 0, stream>>>(
        gdense, cnt, acc, g8, chunks_done, out, w, tiles_x, n_tiles, cap);
  }
  return cudaGetLastError();
}

// Depth-sorted front-to-back compositing over per-tile slot lists, forward.
//
// Replaces the TPU kernel tpu_gaussians/ops/pallas/sorted.py:_sorted_kernel
// (with _a_raw_sep for the axis footprint), launched there by
// _sorted_fwd_call. It computes what that kernel computes, per 16x128-pixel
// tile t, over the tile's depth-ordered slot list (nearest first):
//
//   a_raw = op * exp(-0.5 (a dx^2 + 2 b dx dy + c dy^2))     (pixel centres +0.5)
//         = (op * exp(-0.5 c dy^2)) * exp(-0.5 a dx^2)      (axis footprint, b == 0,
//                                                            the factorised form)
//   a_s   = a_raw < 1e-5 ? 0 : min(a_raw, 0.9999)
//   rgb  += T a_s f_rgb,  zsum += T a_s z,  T *= 1 - a_s
//
// and writes rows [r, g, b, 1 - T, zsum, 0, 0, 0] of out (8, n_tiles*2048).
// Early exit as on the TPU, so that both agree: before each 512-slot chunk
// the whole tile tests max T > exit_t, and stops when no pixel is above it.
// Never per pixel. chunks_done[t] counts the chunks the tile composited.
// sorted_bwd.cu (K4) recomputes T with the expressions of the pixel loop
// below and takes chunks_done as it is.
//
// Bound: f32 ALU and SFU work, about 16 flops (axis) or 22 (EWA) and one
// exp per (slot, pixel) evaluated, against 64 B read per slot and 32 B
// written per pixel. Most listed (slot, pixel) pairs lie outside the slot's
// 1e-5 ellipse, where a_s is 0, so the work the function needs is the live
// pairs' (chip_smoke's live_bound_ms), not the whole tile's.
//
// Design. A tile's pixels are independent; only the exit test couples its
// rows. So each tile is split over a thread-block cluster of S = 8 blocks,
// as in K4: block r owns tile rows 2r and 2r+1, and each of its 128 threads
// one column of those rows, with its two pixels' T, r, g, b and zsum in
// registers. Before each chunk after the first, each block ORs T > exit_t
// over its pixels (__syncthreads_or) into a flag in its shared memory,
// double-buffered by chunk parity, and after one split cluster barrier
// every block ORs the S flags through distributed shared memory: the same
// decision as the whole-tile max, so chunks_done is the one-block kernel's.
// Between the barrier's arrive and its wait the block already issues the
// chunk's cp.async copy into its staging buffer (its reads of the previous
// chunk are over), which a tile that exits simply drops.
//
// Culling, exact. Where a_raw < 1e-5 the pixel loop adds 0 and multiplies T
// by 1: the same bits whether or not it runs. When a chunk has landed, each
// thread takes slots t, t + 128, ... and bounds where the slot can reach
// the cutoff: |dy| <= sqrt(Q a / det) + 1 and |dx| <= sqrt(Q c / det) + 1
// (det = a c - b^2, b = 0 for the axis footprint) with Q = 1.01 (2 ln(op /
// 1e-5) + 1e-4), wide enough for the f32 rounding of the exponent, exp and
// product while det >= 2e-3 a c (so |b| / sqrt(a c) <= 0.999). A slot with
// Q <= 0 touches no pixel; a slot that is not positive definite, is thinner
// than that, or holds a non-finite value is never culled. In two levels:
// a slot whose y-extent misses the block's two rows is listed for none of
// its warps, and one whose x-extent misses a warp's 32 columns is not
// listed for that warp. Each warp gets its own list of slot indices, in
// slot order (per round of 128 slots a ballot per list, then one barrier
// and offsets from the per-warp counts), and walks it with no branch; the
// rows stay where cp.async landed them. For the axis footprint the listing
// also computes each listed slot's row factors op exp(-0.5 c dy^2) for the
// block's two rows (the same expression), so a thread pays one exp per
// slot for both pixels. Per (slot, pixel) the arithmetic is the
// one-block kernel's, expf included: the output is bit for bit its output.
//
// Left for later: ex2.approx for the exps, with K4 (the expressions must
// change in both at once); TMA multicast of a chunk to the cluster (the 8
// blocks read the same rows, L2 hits).
//
// Inputs: gdense (n_tiles*cap, 16) f32 row-major rows
//   [px, py, conic_a, conic_b, conic_c, op, r, g, b, 1, z, 0, 0, 0, 0, 0];
// cnt (n_tiles,) int32 list lengths (<= cap). Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 16;           // tile height (rows)
constexpr int TWC = 128;         // tile width (columns)
constexpr int TPS = TH * TWC;    // pixels per tile
constexpr int NBS = 512;         // slots per chunk: the exit test's step
constexpr int GD = 16;           // floats per slot row
constexpr int S = 8;             // blocks per tile: one cluster
constexpr int PPT = TH / S;      // rows a block owns: pixels per thread
constexpr int THREADS = TWC;     // a thread per column
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = NBS;       // slots staged and listed at a time
constexpr int PER = STAGE / THREADS;   // slots each thread lists
constexpr int REC = 3;           // float4s staged per slot: [px py a b]
                                 // [c op r g] [b 1 z 0]
constexpr bool CULL = true;      // list the slots by their extents
constexpr bool ROW_CULL = true;  // ... by their y-extents too
constexpr bool WARP_LISTS = true;  // a list per warp; else one list for the
                                   // block, which each warp walks, skipping
constexpr bool ROW_TABLE = true;   // axis: row factors once a slot and block
constexpr int LISTS = WARP_LISTS ? 4 : 1;
constexpr int ALL_WARPS = (1 << 4) - 1;
constexpr float ALPHA_CUTOFF = 1e-5f;
constexpr float A_MAX = 0.9999f;
constexpr float Q_SLACK = 1e-4f;       // the extent's slack in Q, added
constexpr float Q_SCALE = 1.01f;       // and then as a factor
constexpr float MIN_DET_RATIO = 2e-3f; // thinner conics are never culled
constexpr float MARGIN_PX = 1.f;       // the extent's margin in pixels

static_assert(STAGE % THREADS == 0 && NBS % STAGE == 0, "stage shape");
static_assert(WARPS == 4, "a mask bit per warp");
static_assert(S * PPT == TH, "the cluster covers the tile's rows");

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The warps (bit w: columns 32w ... 32w + 31) of the block whose rows have
// centres ylo ... yhi that evaluate the slot with row h0 = [px, py, a, b],
// h1 = [c, op, ...]; xt is the tile's first column. The rule is
// kernels/sorted_fwd.slot_extent's.
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

template <bool AXIS>
__global__ void __cluster_dims__(S, 1, 1) __launch_bounds__(THREADS)
sorted_fwd_kernel(const float* __restrict__ gdense,
                  const int* __restrict__ cnt,
                  float* __restrict__ out,
                  int* __restrict__ chunks_done,
                  int tiles_x, int n_tiles, int cap, float exit_t) {
  __shared__ float4 rows[STAGE * REC];     // 24 KB: the staged rows
  __shared__ unsigned short list[LISTS][STAGE];   // 4 KB: listed slots
  __shared__ unsigned char smask[WARP_LISTS ? 1 : STAGE];   // one list's masks
  __shared__ float rowf[AXIS && ROW_TABLE ? STAGE * PPT : 1];   // 4 KB (axis)
  __shared__ int counts[PER][WARPS][LISTS];   // per round, warp and list
  __shared__ int flags[2];                 // T > exit_t here, by chunk parity

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = threadIdx.x;
  const int row0 = PPT * rank;               // rows row0 ... row0 + PPT - 1
  const int xt = (tile % tiles_x) * TWC;
  const float gx = static_cast<float>(xt + col) + 0.5f;
  const int gy0 = (tile / tiles_x) * TH + row0;
  const float ylo = static_cast<float>(gy0) + 0.5f;
  const float yhi = static_cast<float>(gy0 + PPT - 1) + 0.5f;

  float gy[PPT], T[PPT], r[PPT], g[PPT], b[PPT], zs[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    gy[i] = static_cast<float>(gy0 + i) + 0.5f;
    T[i] = 1.f; r[i] = 0.f; g[i] = 0.f; b[i] = 0.f; zs[i] = 0.f;
  }

  const int n_slots = min(cnt[tile], cap);
  const float4* src = reinterpret_cast<const float4*>(
      gdense + static_cast<size_t>(tile) * cap * GD);
  // Rows base ... of the list into rows[], the first REC float4s of each.
  auto stage = [&](int base) {
    const int m = min(STAGE, n_slots - base);
    for (int k = threadIdx.x; k < m * REC; k += THREADS) {
      const int s = k / REC;
      cp_async16(&rows[k], src + static_cast<size_t>(base + s) * (GD / 4)
                                + (k - s * REC));
    }
    asm volatile("cp.async.commit_group;");
  };

  // Every T is 1 before the first chunk: the whole tile's test is 1 > exit_t.
  const bool first = 1.f > exit_t;
  if (first && n_slots > 0) stage(0);
  int chunks = 0;
  bool synced = false;       // a cluster barrier was taken
  for (int base = 0; base < n_slots; base += NBS) {
    if (base == 0) {
      if (!first) break;
    } else {
      bool live = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) live |= T[i] > exit_t;
      // Also the end of this block's reads of the chunk's shared arrays.
      live = __syncthreads_or(live);
      const int par = (base / NBS) & 1;
      if (threadIdx.x == 0) flags[par] = live;
      cluster_arrive();
      stage(base);           // dropped if the tile exits
      cluster_wait();
      synced = true;
      const int f = lane < S ? *cluster.map_shared_rank(&flags[par], lane) : 0;
      if (!__any_sync(0xffffffffu, f)) {
        cp_async_wait_all();
        break;
      }
    }
    const int end = min(base + NBS, n_slots);
    for (int sub = base; sub < end; sub += STAGE) {
      if (sub != base) {     // the previous stage's reads are over
        __syncthreads();
        stage(sub);
      }
      cp_async_wait_all();
      __syncthreads();

      // List: in round k thread t takes slot k * THREADS + t. List l
      // (warp l's, or the block's) holds, in slot order, the slots whose
      // mask has bit l (any bit).
      const int m = min(STAGE, end - sub);
      int mask[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int s = k * THREADS + threadIdx.x;
        mask[k] = s < m ? warp_mask<AXIS>(rows[s * REC], rows[s * REC + 1],
                                          xt, ylo, yhi) : 0;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int s = k * THREADS + threadIdx.x;
#pragma unroll
        for (int l = 0; l < LISTS; ++l) {
          const unsigned in = __ballot_sync(
              0xffffffffu, WARP_LISTS ? (mask[k] >> l) & 1 : mask[k] != 0);
          if (lane == 0) counts[k][warp][l] = __popc(in);
        }
        if constexpr (!WARP_LISTS) smask[s] = mask[k];
        if constexpr (AXIS && ROW_TABLE) if (mask[k]) {
          const float4 h0 = rows[s * REC], h1 = rows[s * REC + 1];
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float dy = gy[i] - h0.y;
            rowf[s * PPT + i] = h1.y * expf(-0.5f * h1.x * (dy * dy));
          }
        }
      }
      __syncthreads();
      int n_list = 0;        // the length of this warp's list
#pragma unroll
      for (int l = 0; l < LISTS; ++l) {
        int base = 0;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const bool bit = WARP_LISTS ? (mask[k] >> l) & 1 : mask[k] != 0;
          const unsigned in = __ballot_sync(0xffffffffu, bit);
          int off = base + __popc(in & ((1u << lane) - 1u));
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            const int c = counts[k][w][l];
            off += w < warp ? c : 0;
            base += c;
          }
          if (bit) list[l][off] = static_cast<unsigned short>(
              k * THREADS + threadIdx.x);
        }
        if (!WARP_LISTS || l == warp) n_list = base;
      }
      __syncthreads();

      // Composite the listed slots in order: every slot a warp does not
      // evaluate has a_raw under the cutoff at all its pixels.
      const unsigned short* mine = list[WARP_LISTS ? warp : 0];
#pragma unroll 4
      for (int j = 0; j < n_list; ++j) {
        const int e = mine[j];
        if constexpr (!WARP_LISTS) if (!((smask[e] >> warp) & 1)) continue;
        const float4 h0 = rows[e * REC + 0];   // px, py, a, b
        const float4 h1 = rows[e * REC + 1];   // c, op, r, g
        const float4 h2 = rows[e * REC + 2];   // b, 1, z, 0
        const float dx = gx - h0.x;
        const float ex = AXIS ? expf(-0.5f * h0.z * (dx * dx)) : 0.f;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float dy = gy[i] - h0.y;
          float a_raw;
          if (AXIS) {
            const float ey = ROW_TABLE
                ? rowf[e * PPT + i]
                : h1.y * expf(-0.5f * h1.x * (dy * dy));
            a_raw = ey * ex;
          } else {
            a_raw = h1.y * expf(-0.5f * (h0.z * dx * dx
                                         + 2.f * h0.w * dx * dy
                                         + h1.x * dy * dy));
          }
          const float a_s = a_raw < ALPHA_CUTOFF ? 0.f : fminf(a_raw, A_MAX);
          const float w = T[i] * a_s;
          r[i] += w * h1.z;
          g[i] += w * h1.w;
          b[i] += w * h2.x;
          zs[i] += w * h2.z;
          T[i] *= 1.f - a_s;
        }
      }
    }
    ++chunks;
  }
  // No block leaves while another may still read its flags.
  if (synced) cluster.sync();

  const size_t plane = static_cast<size_t>(n_tiles) * TPS;
  float* o = out + static_cast<size_t>(tile) * TPS + row0 * TWC + col;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    float* p = o + i * TWC;
    p[0] = r[i];
    p[plane] = g[i];
    p[2 * plane] = b[i];
    p[3 * plane] = 1.f - T[i];
    p[4 * plane] = zs[i];
    p[5 * plane] = 0.f;
    p[6 * plane] = 0.f;
    p[7 * plane] = 0.f;
  }
  if (rank == 0 && threadIdx.x == 0) chunks_done[tile] = chunks;
}

}  // namespace

extern "C" cudaError_t sorted_fwd_launch(const float* gdense, const int* cnt,
                                         float* out, int* chunks_done,
                                         int tiles_x, int n_tiles, int cap,
                                         float exit_t, int axis,
                                         cudaStream_t stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const int blocks = n_tiles * S;   // a cluster of S blocks per tile
  if (axis) {
    sorted_fwd_kernel<true><<<blocks, THREADS, 0, stream>>>(
        gdense, cnt, out, chunks_done, tiles_x, n_tiles, cap, exit_t);
  } else {
    sorted_fwd_kernel<false><<<blocks, THREADS, 0, stream>>>(
        gdense, cnt, out, chunks_done, tiles_x, n_tiles, cap, exit_t);
  }
  return cudaGetLastError();
}

"""Tile binner of the depth-sorted and the tile-binned accumulation
paths: which gaussians each 16x128 pixel tile takes, in what order. Plain
torch, no kernel.

The semantics of the binner half of `tpu_gaussians/ops/pallas/sorted.py`
(`_bin_pairs_2d`, `_tile_rects`, `_zkey_desc`, `_k_pairs`), giving the same
per-tile lists, counts and overflow stats:

  1. Gaussians are sorted once by priority: depth, near first, for
     compositing (zsort=True: the ascending IEEE total-order key of -z,
     ties broken by index, the order of a stable argsort(-z)); opacity,
     strongest first, for the order-independent accumulation (zsort=False).
  2. Each gaussian covers a rectangle of tiles from its cutoff extent
     (1e-5 alpha for compositing), shrunk to at most k tiles around its
     own tile.
  3. The (tile, priority rank) pairs are sorted once by `tile * n + rank`,
     and each tile keeps its first `cap` entries: overflow drops the
     FARTHEST (compositing) or the WEAKEST (accumulation).

The TPU binner's chunked sorts, MXU histogram and 128-wide gathers exist
for XLA's sort and gather costs on that chip; a GPU sorts the pair keys in
one radix sort and gathers directly. Nothing here synchronises with the
host, so a frame's work queues on the device without a round trip.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpu_gaussians_torch.utils import profiling

NBS = 512      # slots per ordered chunk (the kernel's early-exit granularity)
TH = 16        # tile height (pixel rows)
TWC = 128      # tile width (pixel cols)
TPS = TH * TWC # pixels per tile (2048)
ALPHA_CUTOFF = 1e-5
A_MAX = 0.9999 # per-gaussian alpha ceiling (keeps 1/(1 - a) bounded)
EXIT_T = 1e-6  # whole-tile early-exit transmittance threshold

# The per-gaussian tile budget K adapts to scene size so that n*K pairs
# stay near PAIR_BUDGET: small scenes get full splat coverage (up to
# K_MAX), huge scenes (whose splats are small) a tight budget.
PAIR_BUDGET = 12_000_000
K_MIN, K_MAX = 8, 64
# The tile-binned accumulation bins with the W_CULL extents (~8 sigma),
# much wider than the alpha-cutoff ones, so it gets a larger budget and
# floor (`tpu_gaussians/ops/pallas/binned.py:116-117`).
ACCUM_PAIR_BUDGET = 24_000_000
ACCUM_K_MIN = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def k_pairs(n: int, budget: int = PAIR_BUDGET, kmin: int = K_MIN,
            kmax: int = K_MAX) -> int:
    return int(min(kmax, max(kmin, budget // max(n, 1))))


def zkey_desc(z: torch.Tensor) -> torch.Tensor:
    """Key whose ascending order is z DESCENDING (near first), bit-exact:
    the IEEE-754 total-order transform of -z, as a nonnegative int64 in
    [0, 2^32)."""
    bits = (-z).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) != 0
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def tile_rects(px, py, sigma_x, sigma_y, op_eff, tiles_x: int,
               tiles_y: int, k: int, width: int, height: int,
               cutoff: float = ALPHA_CUTOFF):
    """Per-gaussian overlapped-tile rectangle (k-budgeted).

    Extent radius from the alpha cutoff; a rect over the k budget shrinks
    re-centered on the gaussian's own tile. Dead or off-screen gaussians
    get count 0. Returns (tx_lo, ty_lo, kx_c, ky_c, count, clipped) int32,
    with count == kx_c * ky_c and clipped the true overlaps lost to the
    budget."""
    r = torch.sqrt(2.0 * torch.log(torch.clamp(op_eff, min=cutoff) / cutoff))
    dead = op_eff <= cutoff
    rx = r * sigma_x + 1.0
    ry = r * sigma_y + 1.0
    offscreen = (((px + rx) < 0.0) | ((px - rx) >= width)
                 | ((py + ry) < 0.0) | ((py - ry) >= height))

    def tile_of(v, size, hi):
        return torch.clamp(torch.floor(v / size), 0, hi - 1).to(torch.int32)

    tx_lo = tile_of(px - rx, TWC, tiles_x)
    tx_hi = tile_of(px + rx, TWC, tiles_x)
    ty_lo = tile_of(py - ry, TH, tiles_y)
    ty_hi = tile_of(py + ry, TH, tiles_y)
    kx = tx_hi - tx_lo + 1
    ky = ty_hi - ty_lo + 1

    kx_c = torch.clamp(kx, max=k)
    ky_c = torch.minimum(ky, torch.clamp(k // kx_c, min=1))
    txc = tile_of(px, TWC, tiles_x)
    tyc = tile_of(py, TH, tiles_y)
    tx_lo = torch.minimum(torch.maximum(txc - (kx_c - 1) // 2, tx_lo),
                          tx_hi - kx_c + 1)
    ty_lo = torch.minimum(torch.maximum(tyc - (ky_c - 1) // 2, ty_lo),
                          ty_hi - ky_c + 1)

    gone = dead | offscreen
    count = torch.where(gone, 0, kx_c * ky_c).to(torch.int32)
    ky_c = torch.where(count > 0, ky_c, 0)
    clipped = torch.where(gone, 0, kx * ky - count).to(torch.int32)
    return tx_lo, ty_lo, kx_c, ky_c, count, clipped


def bin_pairs_2d(px, py, sigma_x, sigma_y, op_eff, z_cam, tiles_x: int,
                 tiles_y: int, cap: int, width: int, height: int,
                 k: int = 0, cutoff: float = ALPHA_CUTOFF,
                 zsort: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Dict[str, torch.Tensor]]:
    """Dense, priority-ordered per-tile lists of gaussian ids: depth (near
    first) with zsort=True, opacity (strongest first; z_cam is not read,
    and may be None) with zsort=False.

    Returns (slots (n_tiles*cap,) int64 original gaussian ids, n where the
             slot is empty (the packed table's dead row),
             cnt (n_tiles,) int32 per-tile list lengths,
             stats of int64 scalars: dropped_pairs (pairs lost to the
             per-tile capacity, lowest priority first), full_tiles (tiles
             whose true load exceeded cap), clipped_rect_pairs (true
             overlaps lost to the per-gaussian k-tile budget)).
    Under a profiler the overlaps within that budget (cnt sums to them
    less dropped_pairs), dropped_pairs and clipped_rect_pairs are the
    counters gs.binner.pairs, .dropped and .clipped (device scalars;
    utils/profiling.count).
    """
    n = px.shape[0]
    dev = px.device
    n_tiles = tiles_x * tiles_y
    if k <= 0:
        k = k_pairs(n)

    index = torch.arange(n, dtype=torch.int64, device=dev)
    prio = zkey_desc(z_cam) if zsort else zkey_desc(op_eff)
    order = torch.sort((prio << 31) | index).values & (2**31 - 1)
    tx_lo, ty_lo, kx_c, ky_c, count, clipped = tile_rects(
        px[order], py[order], sigma_x[order], sigma_y[order], op_eff[order],
        tiles_x, tiles_y, k, width, height, cutoff=cutoff)

    # Pair (rank g, j < count[g]) covers tile (ty_lo + j // kx, tx_lo +
    # j % kx); unused j get the key of a sentinel tile n_tiles, which
    # sorts last.
    j = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    kx = kx_c[:, None]
    tile = ((ty_lo[:, None] + j // kx) * tiles_x
            + tx_lo[:, None] + j % kx).to(torch.int64)
    tile = torch.where(j < count[:, None], tile, n_tiles)
    key = torch.sort((tile * n + index[:, None]).reshape(-1)).values

    # Tile t's pairs are key_s[starts[t] : starts[t+1]], nearest first.
    starts = torch.searchsorted(
        key, torch.arange(n_tiles + 1, dtype=torch.int64, device=dev) * n)
    load = starts[1:] - starts[:-1]
    cnt = torch.clamp(load, max=cap).to(torch.int32)
    rank = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    pos = torch.clamp(starts[:-1, None] + rank, max=key.shape[0] - 1)
    slots = torch.where(rank < cnt[:, None], order[key[pos] % n], n)
    stats = {
        "dropped_pairs": torch.clamp(load - cap, min=0).sum(),
        "full_tiles": (load > cap).sum(),
        "clipped_rect_pairs": clipped.to(torch.int64).sum(),
    }
    profiling.count("gs.binner.pairs", starts[-1])
    profiling.count("gs.binner.dropped", stats["dropped_pairs"])
    profiling.count("gs.binner.clipped", stats["clipped_rect_pairs"])
    return slots.reshape(-1), cnt, stats

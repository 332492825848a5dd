"""Tile-binned accumulation, the at-scale EWA training path: the
counterpart of `tpu_gaussians.ops.pallas.binned`.

The dense band kernels (ops/splat.py) cull only along y, so at large n
with small splats most (gaussian, pixel) work is wasted. This path reuses
the sorted path's tile binner (ops/binning.bin_pairs_2d) with zsort=False:
lists are ordered by opacity, strongest first, so that capacity overflow
drops the weakest gaussians, and only true (gaussian, 16x128 tile)
overlaps are accumulated. With the default W_CULL extent and nothing
dropped, the sum equals the dense path's to float tolerance.

`_BinnedCore` runs K8a forward and K8b backward (kernels/binned.py) on the
row-major per-slot table `index_select(pack_gdata(s), 0, slots)`, or for
the axis footprint (conic b == 0) the separable K7a and K7b; the O(slots)
post-pass (`ops/sorted.moment_postpass`, or `moment_postpass_opfold` after
K7b) gives the slot rows' gradients, and the backward of `index_select`
(an `index_add_`) sums them into the gaussians.
"""

from __future__ import annotations

import sys

import torch

from tpu_gaussians_torch.kernels.binned import (
    binned_bwd, binned_fwd, binned_sep_bwd, binned_sep_fwd)
from tpu_gaussians_torch.kernels.sorted_fwd import FEAT_PAD
from tpu_gaussians_torch.ops.binning import (  # noqa: F401 (re-exported)
    ACCUM_K_MIN, ACCUM_PAIR_BUDGET, ALPHA_CUTOFF, NBS, TH, TWC, _round_up,
    bin_pairs_2d, k_pairs)
from tpu_gaussians_torch.ops.common import FEAT_DIM, SplatInputs
from tpu_gaussians_torch.ops.sorted import (
    crop_tiled_acc, moment_postpass, pack_gdata)
from tpu_gaussians_torch.ops.splat import W_CULL  # noqa: F401 (re-exported)

# EWA accumulation at or above this many gaussians takes the tile-binned
# kernels under accum_binned="auto" (`tpu_gaussians.ops.pallas.binned.
# BINNED_MIN_N`: the dense EWA backward's cost passes binned's near 10k).
BINNED_MIN_N = 10_240


def binned_min_n(axis: bool) -> int:
    """The n from which accum_binned="auto" bins: never for the axis
    footprint (its dense band kernels win at every n), BINNED_MIN_N for
    EWA (binned.py:106-109)."""
    return sys.maxsize if axis else BINNED_MIN_N


def default_tile_capacity(n: int, cutoff: float = W_CULL,
                          tile_capacity: int = 0) -> int:
    """Per-tile list capacity, a multiple of 512 (binned.py:484-504): 0
    picks min(n rounded up, 8192), or 4096 under a cutoff at least as
    strong as ALPHA_CUTOFF, whose extents are ~0.6x as wide."""
    if tile_capacity <= 0:
        base = 4096 if cutoff >= ALPHA_CUTOFF else 8192
        tile_capacity = min(_round_up(n, NBS), max(base, NBS))
    return _round_up(tile_capacity, NBS)


def moment_postpass_opfold(gdense: torch.Tensor,
                           raw: torch.Tensor) -> torch.Tensor:
    """K7b's raw slot rows [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop(8), ...] ->
    gradients of the gdense rows (`moment_postpass_opfold_t`, binned.py:
    329-347): g_px = a Mdx, g_py = c Mdy, g_a = -Mxx/2, g_b = 0 (the axis
    constant), g_c = -Myy/2, g_op = sum_f feats_f g_featop_f and
    g_feat = op g_featop (the product rule of featsop = feats op)."""
    a, c, op = gdense[:, 2], gdense[:, 4], gdense[:, 5]
    feats = gdense[:, 6:6 + FEAT_PAD]
    mdx, mdy, mxx, _, myy = raw[:, :5].unbind(dim=1)
    g_featop = raw[:, 6:6 + FEAT_PAD]
    head = torch.stack([a * mdx, c * mdy, -0.5 * mxx, torch.zeros_like(mdx),
                        -0.5 * myy, (feats * g_featop).sum(dim=1)], dim=1)
    return torch.cat([head, g_featop * op[:, None],
                      torch.zeros_like(raw[:, 6 + FEAT_PAD:])], dim=1)


class _BinnedCore(torch.autograd.Function):
    """acc (8, n_tiles*2048) over the per-tile lists through K8a, or K7a
    when sep (the axis footprint); differentiable in gdense through K8b and
    moment_postpass, or K7b and moment_postpass_opfold (`_binned_core`,
    binned.py:424-452)."""

    @staticmethod
    def forward(ctx, gdense, cnt, tiles_x: int, sep: bool):
        ctx.save_for_backward(gdense, cnt)
        ctx.tiles_x, ctx.sep = tiles_x, sep
        return (binned_sep_fwd if sep else binned_fwd)(gdense, cnt, tiles_x)

    @staticmethod
    def backward(ctx, g_acc):
        gdense, cnt = ctx.saved_tensors
        if ctx.sep:
            raw = binned_sep_bwd(gdense, cnt, g_acc.contiguous(), ctx.tiles_x)
            return moment_postpass_opfold(gdense, raw), None, None, None
        raw = binned_bwd(gdense, cnt, g_acc.contiguous(), ctx.tiles_x)
        return moment_postpass(gdense, raw), None, None, None


def accum_lists(s: SplatInputs, height: int, width: int,
                tile_capacity: int = 0, cutoff: float = W_CULL):
    """Bin and gather -> (gdense (n_tiles*cap, 16), cnt (n_tiles,) int32,
    tiles_x, tiles_y, overflow stats): K8's inputs, the lists strongest
    first (binned.py:478-517). gdense is differentiable in s; the binning
    sees detached inputs."""
    n = s.px.shape[0]
    tiles_x = _round_up(width, TWC) // TWC
    tiles_y = _round_up(height, TH) // TH
    cap = default_tile_capacity(n, cutoff, tile_capacity)
    k = k_pairs(n, budget=ACCUM_PAIR_BUDGET, kmin=ACCUM_K_MIN)
    with torch.no_grad():
        slots, cnt, stats = bin_pairs_2d(
            s.px, s.py, s.sigma_x, s.sigma_y, s.op_eff, None,
            tiles_x, tiles_y, cap, width, height, cutoff=cutoff,
            zsort=False, k=k)
    # index_select: its backward is the slot -> gaussian index_add_ (see
    # ops/sorted.tile_lists).
    gdense = torch.index_select(pack_gdata(s), 0, slots)
    return gdense, cnt, tiles_x, tiles_y, stats


def splat_accumulate_binned(
    s: SplatInputs, height: int, width: int, tile_capacity: int = 0,
    axis: bool = False, return_stats: bool = False, cutoff: float = W_CULL,
):
    """Tile-binned drop-in for ops/splat.splat_accumulate -> acc (H*W, 5)
    [+ the binner's overflow stats when return_stats]. Differentiable in
    every SplatInputs field but sigma_x/y.

    cutoff sets the binning extent: W_CULL (default) agrees with the dense
    kernels when nothing is dropped; ALPHA_CUTOFF drops the sub-1e-5 tails
    at the extent level for ~3x fewer pairs. axis=True is the caller's
    promise that conic_b == 0: the separable tile kernels K7a/K7b."""
    gdense, cnt, tiles_x, tiles_y, stats = accum_lists(
        s, height, width, tile_capacity, cutoff)
    acc = _BinnedCore.apply(gdense, cnt, tiles_x, axis)
    full = crop_tiled_acc(acc, tiles_y, tiles_x, height, width)
    out = full[..., :FEAT_DIM].reshape(-1, FEAT_DIM)
    return (out, stats) if return_stats else out

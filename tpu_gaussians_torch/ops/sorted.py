"""Depth-sorted compositing on 16x128 pixel tiles, with its gradient: the
counterpart of `tpu_gaussians.ops.pallas.sorted.sorted_composite_pallas`.

  order: camera-space z descending (near first)
  per gaussian: a = clamp(op * exp(e), 0, 0.9999), dropped when a < 1e-5
  front-to-back: contrib = T * a, T *= (1 - a) per pixel
  finalize: image = clip(rgb + (1 - alpha) * bg, 0, 1),
            depth = max(zsum / (alpha + 1e-6), 0)

The binner (ops/binning.py) builds each tile's depth-ordered list of at
most `band_capacity` gaussians (overflow drops the farthest); the rows of
those lists are gathered from the packed per-gaussian table into one
row-major (n_tiles*cap, 16) array. `_SortedCore` composites every tile
with `kernels.sorted_fwd.sorted_tiles` (K3) and differentiates it with
`kernels.sorted_bwd.sorted_bwd` (K4) and `moment_postpass`: the CUDA
kernels on the card, their plain twins on the CPU.

The binning is integer selection and carries no gradient; the gather's
backward (an index_add over slots) is the slot -> gaussian reduction.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpu_gaussians_torch.kernels.sorted_bwd import sorted_bwd
from tpu_gaussians_torch.kernels.sorted_fwd import (
    FEAT_PAD, GD_ROWS, sorted_tiles)
from tpu_gaussians_torch.ops.binning import (
    EXIT_T, K_MIN, NBS, TH, TWC, _round_up, bin_pairs_2d, k_pairs,
    tile_rects)
from tpu_gaussians_torch.ops.common import SplatInputs, prepare_splats
from tpu_gaussians_torch.utils.profiling import annotate


def pack_gdata(s: SplatInputs) -> torch.Tensor:
    """Row-major packed per-gaussian data (n+1, 16): rows [px, py, ca, cb,
    cc, op, feats(8), pad]; row n is the dead slot (zero opacity, identity
    conic). Differentiable in every field but sigma_x/y."""
    n, nf = s.feats.shape
    head = torch.stack([s.px, s.py, s.conic_a, s.conic_b, s.conic_c,
                        s.op_eff], dim=1)
    feats = torch.nn.functional.pad(s.feats, (0, GD_ROWS - 6 - nf))
    dead = torch.zeros((1, GD_ROWS), dtype=torch.float32, device=s.px.device)
    dead[0, 2] = dead[0, 4] = 1.0
    return torch.cat([torch.cat([head, feats], dim=1), dead], dim=0)


def moment_postpass(gdense: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """K4's raw slot rows [Mdx, Mdy, Mxx, Mxy, Myy, M0, g_feat(8), ...] ->
    gradients of the gdense rows (`moment_postpass_t`, sorted.py:881-901).
    For e = -(a dx^2 + 2 b dx dy + c dy^2)/2 and w = op exp(e):
      g_px = a Mdx + b Mdy, g_py = b Mdx + c Mdy,
      g_{a,b,c} = -(Mxx/2, Mxy, Myy/2), g_op = M0 / op (0 where op <= 0)."""
    a, b, c, op = gdense[:, 2], gdense[:, 3], gdense[:, 4], gdense[:, 5]
    mdx, mdy, mxx, mxy, myy, m0 = raw[:, :6].unbind(dim=1)
    live = op > 0
    g_op = torch.where(live, m0 / torch.where(live, op, torch.ones_like(op)),
                       torch.zeros_like(op))
    head = torch.stack([a * mdx + b * mdy, b * mdx + c * mdy, -0.5 * mxx,
                        -mxy, -0.5 * myy, g_op], dim=1)
    return torch.cat([head, raw[:, 6:6 + FEAT_PAD],
                      torch.zeros_like(raw[:, 6 + FEAT_PAD:])], dim=1)


class _SortedCore(torch.autograd.Function):
    """(acc (8, n_tiles*2048), chunks_done) of the per-tile lists through
    K3; differentiable in gdense through K4 and the post-pass, with the
    forward's own exit decisions (`_sorted_core`, sorted.py:1189-1220)."""

    @staticmethod
    def forward(ctx, gdense, cnt, tiles_x: int, axis: bool, exit_t: float):
        with annotate("gs.composite.fwd"):
            acc, chunks = sorted_tiles(gdense, cnt, tiles_x, axis=axis,
                                       exit_t=exit_t)
        ctx.save_for_backward(gdense, cnt, acc, chunks)
        ctx.tiles_x, ctx.axis = tiles_x, axis
        ctx.mark_non_differentiable(chunks)
        return acc, chunks

    @staticmethod
    def backward(ctx, g_acc, _):
        gdense, cnt, acc, chunks = ctx.saved_tensors
        with annotate("gs.composite.bwd"):
            raw = sorted_bwd(gdense, cnt, acc, g_acc.contiguous(), chunks,
                             ctx.tiles_x, ctx.axis)
            return moment_postpass(gdense, raw), None, None, None, None


def crop_tiled_acc(acc: torch.Tensor, tiles_y: int, tiles_x: int,
                   height: int, width: int) -> torch.Tensor:
    """(FEAT_PAD, tiles*2048) compositing output -> (H, W, FEAT_PAD)."""
    full = acc.reshape(FEAT_PAD, tiles_y, tiles_x, TH, TWC)
    full = full.permute(1, 3, 2, 4, 0).reshape(
        tiles_y * TH, tiles_x * TWC, FEAT_PAD)
    return full[:height, :width]


def default_band_capacity(n: int, band_capacity: int = 0) -> int:
    """Per-tile list capacity, a multiple of 512. 0 picks min(n rounded up,
    2048): lossless for small/medium scenes (cap >= n); in dense ones the
    early exit hides whatever lies behind a few hundred near-opaque
    splats."""
    if band_capacity <= 0:
        band_capacity = min(_round_up(n, NBS), max(2048, NBS))
    return _round_up(band_capacity, NBS)


def auto_pair_k(g, views: torch.Tensor, projs: torch.Tensor, width: int,
                height: int, footprint: str = "axis") -> int:
    """The per-gaussian tile budget for training (`auto_pair_k`,
    sorted.py:98-130): the largest tile rect of any gaussian over every
    training camera at the initial parameters, rounded up to a power of
    two, at least K_MIN and at most k_pairs(n). Rects that later outgrow it
    are clipped and counted in the binner's clipped_rect_pairs."""
    tiles_x = _round_up(width, TWC) // TWC
    tiles_y = _round_up(height, TH) // TH
    with torch.no_grad():
        counts = []
        for view, proj in zip(views, projs):
            s = prepare_splats(g, view, proj, width, height,
                               footprint=footprint)
            counts.append(tile_rects(
                s.px, s.py, s.sigma_x, s.sigma_y, s.op_eff, tiles_x,
                tiles_y, tiles_x * tiles_y, width, height)[4].max())
        mx = int(torch.stack(counts).max())
    k = 1 << max(0, (mx - 1).bit_length())              # pow2ceil(mx)
    return int(min(max(K_MIN, k), k_pairs(g.means.shape[0])))


def tile_lists(s: SplatInputs, z_cam: torch.Tensor, height: int, width: int,
               band_capacity: int = 0, pair_k: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, int, int,
                          Dict[str, torch.Tensor]]:
    """Bin and gather -> (gdense (n_tiles*cap, 16), cnt (n_tiles,) int32,
    tiles_x, tiles_y, overflow stats): the compositing kernel's inputs.
    gdense is differentiable in s; the binning sees detached inputs."""
    n = s.px.shape[0]
    tiles_x = _round_up(width, TWC) // TWC
    tiles_y = _round_up(height, TH) // TH
    cap = default_band_capacity(n, band_capacity)
    with annotate("gs.binner"):
        with torch.no_grad():
            slots, cnt, stats = bin_pairs_2d(
                s.px, s.py, s.sigma_x, s.sigma_y, s.op_eff, z_cam,
                tiles_x, tiles_y, cap, width, height, k=pair_k)
        # index_select's backward is an index_add_ of the slot rows into
        # the gaussians' (atomics on the card; a trace names its node
        # IndexSelectBackward0). Indexing with [] would take torch's sorted
        # index_put backward, which walks each gaussian's duplicates in one
        # thread: the dead row n holds every empty slot.
        gdense = torch.index_select(pack_gdata(s), 0, slots)
    return gdense, cnt, tiles_x, tiles_y, stats


def resolve_sorted(acc: torch.Tensor, background: torch.Tensor,
                   tiles_y: int, tiles_x: int, height: int, width: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compositing output -> (image (H,W,3), alpha (H,W), depth (H,W))."""
    full = crop_tiled_acc(acc, tiles_y, tiles_x, height, width)
    alpha = full[..., 3]
    image = full[..., :3] + (1.0 - alpha)[..., None] * background
    depth = torch.clamp(full[..., 4] / (alpha + 1e-6), min=0.0)
    return torch.clamp(image, 0.0, 1.0), alpha, depth


def sorted_composite(
    s: SplatInputs, z_cam: torch.Tensor, background: torch.Tensor,
    height: int, width: int, band_capacity: int = 0,
    axis: bool = False, return_stats: bool = False,
    exit_t: float = EXIT_T, pair_k: int = 0,
):
    """Depth-sorted render -> (image (H,W,3), alpha (H,W), depth (H,W))
    [+ binner overflow stats dict when return_stats]. Differentiable in
    every SplatInputs field but sigma_x/y, and in background.

    exit_t / pair_k / band_capacity are the forward-quality knobs of the
    interactive viewer preset; axis=True asserts conic b == 0 and takes
    the kernels' factorised alpha (and a zero gradient for conic_b)."""
    gdense, cnt, tiles_x, tiles_y, stats = tile_lists(
        s, z_cam, height, width, band_capacity, pair_k)
    acc, _ = _SortedCore.apply(gdense, cnt, tiles_x, axis, exit_t)
    out = resolve_sorted(acc, background, tiles_y, tiles_x, height, width)
    return out + (stats,) if return_stats else out

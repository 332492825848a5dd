"""Depth-sorted compositing on 16x128 pixel tiles (forward only): the
counterpart of `tpu_gaussians.ops.pallas.sorted.sorted_composite_pallas`.

  order: camera-space z descending (near first)
  per gaussian: a = clamp(op * exp(e), 0, 0.9999), dropped when a < 1e-5
  front-to-back: contrib = T * a, T *= (1 - a) per pixel
  finalize: image = clip(rgb + (1 - alpha) * bg, 0, 1),
            depth = max(zsum / (alpha + 1e-6), 0)

The binner (ops/binning.py) builds each tile's depth-ordered list of at
most `band_capacity` gaussians (overflow drops the farthest); the rows of
those lists are gathered from the packed per-gaussian table into one
row-major (n_tiles*cap, 16) array, and `kernels.sorted_fwd.sorted_tiles`
composites every tile: the CUDA kernel on the card, its plain twin on
the CPU.

This slice has no backward: sorted training (the TPU package's fused
backward kernel) comes with the training slice, and inputs that require
grad are refused rather than given a wrong gradient.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tpu_gaussians_torch.kernels.sorted_fwd import (
    FEAT_PAD, GD_ROWS, sorted_tiles)
from tpu_gaussians_torch.ops.binning import (
    EXIT_T, NBS, TH, TWC, _round_up, bin_pairs_2d)
from tpu_gaussians_torch.ops.common import SplatInputs


def pack_gdata(s: SplatInputs) -> torch.Tensor:
    """Row-major packed per-gaussian data (n+1, 16): rows [px, py, ca, cb,
    cc, op, feats(8), pad]; row n is the dead slot (zero opacity, identity
    conic)."""
    n, nf = s.feats.shape
    packed = torch.zeros((n + 1, GD_ROWS), dtype=torch.float32,
                         device=s.px.device)
    packed[:n, :6] = torch.stack([s.px, s.py, s.conic_a, s.conic_b,
                                  s.conic_c, s.op_eff], dim=1)
    packed[:n, 6:6 + nf] = s.feats
    packed[n, 2] = 1.0
    packed[n, 4] = 1.0
    return packed


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


def tile_lists(s: SplatInputs, z_cam: torch.Tensor, height: int, width: int,
               band_capacity: int = 0, pair_k: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, int, int,
                          Dict[str, torch.Tensor]]:
    """Bin and gather -> (gdense (n_tiles*cap, 16), cnt (n_tiles,) int32,
    tiles_x, tiles_y, overflow stats): the compositing kernel's inputs."""
    n = s.px.shape[0]
    tiles_x = _round_up(width, TWC) // TWC
    tiles_y = _round_up(height, TH) // TH
    cap = default_band_capacity(n, band_capacity)
    slots, cnt, stats = bin_pairs_2d(
        s.px, s.py, s.sigma_x, s.sigma_y, s.op_eff, z_cam,
        tiles_x, tiles_y, cap, width, height, k=pair_k)
    return pack_gdata(s)[slots], cnt, tiles_x, tiles_y, stats


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
    [+ binner overflow stats dict when return_stats].

    exit_t / pair_k / band_capacity are the forward-quality knobs of the
    interactive viewer preset; axis=True asserts conic b == 0 and takes
    the kernel's factorised alpha."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*s, z_cam, background)):
        raise RuntimeError(
            "the tiled sorted path is forward-only in this package; its "
            "backward comes with the training slice. Render under "
            "torch.no_grad(), or use impl='torch' for autograd")
    gdense, cnt, tiles_x, tiles_y, stats = tile_lists(
        s, z_cam, height, width, band_capacity, pair_k)
    acc, _ = sorted_tiles(gdense, cnt, tiles_x, axis=axis, exit_t=exit_t)
    out = resolve_sorted(acc, background, tiles_y, tiles_x, height, width)
    return out + (stats,) if return_stats else out

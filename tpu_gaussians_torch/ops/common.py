"""Shared renderer plumbing: the per-Gaussian screen stage and the pixel
grid, as in `tpu_gaussians.ops.common`.

Footprints are screen-space conics: compositing evaluates
  w = op * exp(-0.5*(a dx^2 + 2 b dx dy + c dy^2))
for every (gaussian, pixel) pair. "axis" is the reference's axis-aligned
sigma (a = 1/sigma_x^2, b = 0, c = 1/sigma_y^2); "ewa" the quaternion +
scale covariance projected by the EWA Jacobian (ops/ewa.py).

Feature layout: feat = [r, g, b, 1, z_abs], so one contraction through the
weights gives color, weight sum and the depth numerator together.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu_gaussians_torch.core.types import Gaussians
from tpu_gaussians_torch.ops.ewa import axis_aligned_conic, ewa_conic
from tpu_gaussians_torch.ops.projection import project
from tpu_gaussians_torch.ops.sh import eval_colors

FEAT_DIM = 5  # [r, g, b, 1, z]


class SplatInputs(NamedTuple):
    """Per-Gaussian inputs to compositing, all screen-space."""

    px: torch.Tensor       # (N,)
    py: torch.Tensor       # (N,)
    conic_a: torch.Tensor  # (N,) conic xx coefficient
    conic_b: torch.Tensor  # (N,) conic xy coefficient (0 for axis-aligned)
    conic_c: torch.Tensor  # (N,) conic yy coefficient
    sigma_x: torch.Tensor  # (N,) effective x stddev in px (culling only)
    sigma_y: torch.Tensor  # (N,) effective y stddev in px (culling only)
    op_eff: torch.Tensor   # (N,) effective opacity = max(op,0)*valid*alive
    feats: torch.Tensor    # (N, FEAT_DIM) = [r, g, b, 1, z_abs]


def prepare_splats(g: Gaussians, view: torch.Tensor, proj: torch.Tensor,
                   width: int, height: int,
                   footprint: str = "axis") -> SplatInputs:
    """O(N) per-Gaussian stage: projection, footprint conic, color eval,
    masking (torch_renderer.py:143-150, color clamp :144, validity :185),
    with the alive-capacity mask folded into the opacity."""
    s = project(g.means, view, proj, width, height, g.scales)
    colors = eval_colors(g.sh if g.use_sh else g.colors, g.means, view)
    colors = torch.clamp(colors, 0.0, 1.0)

    if footprint == "ewa":
        quats = g.quats
        if quats is None:
            quats = torch.zeros((g.capacity, 4), dtype=torch.float32,
                                device=g.device)
            quats[:, 0] = 1.0
        conic = ewa_conic(g.means, g.scales, quats, view, proj, width, height)
    else:
        conic = axis_aligned_conic(s.sigma_x, s.sigma_y)

    op_eff = torch.clamp(g.opacities, min=0.0) * s.valid * g.alive_mask()
    feats = torch.cat([colors, torch.ones_like(s.z_abs)[:, None],
                       s.z_abs[:, None]], dim=1)
    return SplatInputs(
        px=s.px, py=s.py,
        conic_a=conic.a, conic_b=conic.b, conic_c=conic.c,
        sigma_x=conic.sigma_x, sigma_y=conic.sigma_y,
        op_eff=op_eff, feats=feats,
    )


def pixel_grid(height: int, width: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened pixel-center coordinates gx, gy of shape (H*W,), pixel
    centers at +0.5."""
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)

"""Shared renderer plumbing: the per-Gaussian screen stage and the pixel
grid, as in `tpu_gaussians.ops.common`.

Footprints are screen-space conics: compositing evaluates
  w = op * exp(-0.5*(a dx^2 + 2 b dx dy + c dy^2))
for every (gaussian, pixel) pair. "axis" is the reference's axis-aligned
sigma (a = 1/sigma_x^2, b = 0, c = 1/sigma_y^2); "ewa" the quaternion +
scale covariance projected by the EWA Jacobian (ops/ewa.py).

Feature layout: feat = [r, g, b, 1, z_abs], so one contraction through the
weights gives color, weight sum and the depth numerator together: the
accumulation mode's acc[p, :] = sum_i w_ip feat_i has columns
[R, G, B, Wsum, D].
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu_gaussians_torch.core.types import Gaussians
from tpu_gaussians_torch.kernels.stage import stage
from tpu_gaussians_torch.utils.profiling import annotate

FEAT_DIM = 5  # [r, g, b, 1, z]
COL_R, COL_G, COL_B, COL_W, COL_D = range(FEAT_DIM)


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
    with the alive-capacity mask folded into the opacity: one kernel each
    way on the card (kernels/stage.py). Its forward is the span
    `gs.stage`, its backward `gs.stage.bwd`."""
    with annotate("gs.stage"):
        alive = None if g.alive is None else g.alive_mask()
        return SplatInputs(*stage(
            g.means, g.scales, g.quats, g.sh if g.use_sh else g.colors,
            g.opacities, alive, view, proj, width, height,
            ewa=footprint == "ewa"))


def resolve_accum(acc: torch.Tensor, background: torch.Tensor, height: int,
                  width: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(HW) resolve of the weighted-average mode (torch_renderer.py:
    192-203): acc (H*W, 5) -> image clip((bg + RGB) / (1 + Wsum), 0, 1),
    alpha clip(Wsum / (1 + Wsum), 0, 1), depth max(D / (Wsum + 1e-6), 0)."""
    rgb = acc[:, COL_R:COL_B + 1].reshape(height, width, 3)
    wsum = acc[:, COL_W].reshape(height, width)
    d = acc[:, COL_D].reshape(height, width)
    denom = 1.0 + wsum
    image = torch.clamp((background[None, None, :] + rgb) / denom[..., None],
                        0.0, 1.0)
    alpha = torch.clamp(wsum / denom, 0.0, 1.0)
    depth = torch.clamp(d / (wsum + 1e-6), min=0.0)
    return image, alpha, depth


def pixel_grid(height: int, width: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened pixel-center coordinates gx, gy of shape (H*W,), pixel
    centers at +0.5."""
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx.reshape(-1), gy.reshape(-1)

"""Projection of Gaussian centers to screen space + footprint sigmas.

Semantics of `tpu_gaussians.ops.projection` (reference
torch_renderer.py:57-78 `_project` and :146-150 sigma):

  p_cam  = view @ [mean, 1]
  p_clip = proj @ p_cam
  w_safe = 1 if |w| < 1e-8 else w
  ndc    = p_clip.xyz / w_safe
  px     = (ndc_x * 0.5 + 0.5) * (W - 1)
  py     = (1 - (ndc_y * 0.5 + 0.5)) * (H - 1)   (y-flip)
  valid  = (-1 <= ndc_z <= 1) and (w != 0)
  z_abs  = max(|p_cam_z|, 1e-6)
  sigma_x = max(|scale_x| * 0.5 * W * |proj[0,0]| / z_abs, 1.0)
  sigma_y = max(|scale_y| * 0.5 * H * |proj[1,1]| / z_abs, 1.0)

All float32. The matmuls must stay true f32 (the JAX package asks for
precision="highest"): on CUDA, `core.types.resolve_device` sets
`torch.backends.cuda.matmul.allow_tf32 = False`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class ScreenSplats(NamedTuple):
    """Per-Gaussian screen-space quantities for one camera."""

    px: torch.Tensor       # (N,) pixel-center x
    py: torch.Tensor       # (N,) pixel-center y (y-down)
    z_abs: torch.Tensor    # (N,) |camera-space z|, clamped >= 1e-6
    valid: torch.Tensor    # (N,) float32 {0,1} visibility mask
    sigma_x: torch.Tensor  # (N,) screen-space stddev in x, clamped >= 1
    sigma_y: torch.Tensor  # (N,) screen-space stddev in y, clamped >= 1


def clip_space(means: torch.Tensor, view: torch.Tensor, proj: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """means (N,3) -> (p_cam (N,4), p_clip (N,4), w_safe (N,1)): camera and
    clip coordinates, and the clip w with |w| < 1e-8 replaced by 1."""
    ones = torch.ones((means.shape[0], 1), dtype=means.dtype,
                      device=means.device)
    p_obj = torch.cat([means, ones], dim=1)        # (N,4)
    p_cam = p_obj @ view.T                         # (N,4)
    p_clip = p_cam @ proj.T                        # (N,4)
    w = p_clip[:, 3:4]
    w_safe = torch.where(w.abs() < 1e-8, torch.ones_like(w), w)
    return p_cam, p_clip, w_safe


def axis_sigma(scale: torch.Tensor, size: int, focal: torch.Tensor,
               z_abs: torch.Tensor) -> torch.Tensor:
    """|scale| * 0.5 * size * |focal| / z_abs: a screen sigma in pixels
    before its floor of 1."""
    return scale.abs() * 0.5 * size * focal.abs() / z_abs


def project(means: torch.Tensor, view: torch.Tensor, proj: torch.Tensor,
            width: int, height: int, scales: torch.Tensor) -> ScreenSplats:
    """means (N,3), scales (N,3), view/proj (4,4) -> ScreenSplats of (N,)."""
    p_cam, p_clip, w_safe = clip_space(means, view, proj)
    w = p_clip[:, 3:4]
    ndc = p_clip[:, :3] / w_safe

    px = (ndc[:, 0] * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * (height - 1)

    valid = ((ndc[:, 2] >= -1.0) & (ndc[:, 2] <= 1.0)
             & (w[:, 0] != 0.0)).to(torch.float32)
    z_abs = torch.clamp(p_cam[:, 2].abs(), min=1e-6)

    sigma_x = torch.clamp(axis_sigma(scales[:, 0], width, proj[0, 0], z_abs),
                          min=1.0)
    sigma_y = torch.clamp(axis_sigma(scales[:, 1], height, proj[1, 1],
                                     z_abs), min=1.0)
    return ScreenSplats(px=px, py=py, z_abs=z_abs, valid=valid,
                        sigma_x=sigma_x, sigma_y=sigma_y)


def camera_z(means: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """Signed camera-space z of each center (depth-sort key; larger z =
    closer, renderer_cpu.cpp:137-146)."""
    return means @ view[2, :3] + view[2, 3]

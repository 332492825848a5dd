"""Whole-frame plain renderer: the `impl="torch"` path and this package's
oracle, the counterpart of `tpu_gaussians.ops.jnp_renderer.composite_sorted`.

Depth-sorted front-to-back compositing (renderer_cpu.cpp:125-217):
  order: camera-space z descending (larger z = closer)
  per Gaussian: a = clamp01(op * exp(e)), dropped when a < 1e-5
  front-to-back: contrib = (1 - A) * a;  rgb += contrib * c;  A += contrib
  finalize: out = clip(rgb + (1 - A) * bg, 0, 1)

Each chunk of the sorted order is over-composited in one vectorized pass
(within-chunk transmittance by cumprod) and chunks merge in order with the
associative `over` operator. Differentiable through torch autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_gaussians_torch.ops.common import SplatInputs, pixel_grid


def _chunk_weights(px, py, ca, cb, cc, op, gx, gy) -> torch.Tensor:
    """w_ip = op_i * exp(-0.5 * (a dx^2 + 2 b dx dy + c dy^2)): (C, HW)."""
    dx = gx[None, :] - px[:, None]
    dy = gy[None, :] - py[:, None]
    e = -0.5 * (ca[:, None] * dx * dx + 2.0 * cb[:, None] * dx * dy
                + cc[:, None] * dy * dy)
    return op[:, None] * torch.exp(e)


def composite_sorted(
    s: SplatInputs,
    z_cam: torch.Tensor,
    background: torch.Tensor,
    height: int,
    width: int,
    chunk: int = 64,
    alpha_cutoff: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (image (H,W,3), alpha (H,W), depth (H,W)); depth is
    sum_i contrib_i * z_abs_i / (alpha + 1e-6)."""
    order = torch.argsort(-z_cam, stable=True)
    gx, gy = pixel_grid(height, width, z_cam.device)
    hw = height * width
    rgbd = torch.zeros((hw, 4), dtype=torch.float32, device=z_cam.device)
    alpha = torch.zeros((hw,), dtype=torch.float32, device=z_cam.device)
    for lo in range(0, order.shape[0], chunk):
        idx = order[lo:lo + chunk]
        a = _chunk_weights(s.px[idx], s.py[idx], s.conic_a[idx],
                           s.conic_b[idx], s.conic_c[idx], s.op_eff[idx],
                           gx, gy)
        a = torch.clamp(a, 0.0, 1.0)
        a = torch.where(a < alpha_cutoff, torch.zeros_like(a), a)
        # Transmittance before each element of the chunk: exclusive cumprod.
        t_before = torch.cat([torch.ones_like(a[:1]),
                              torch.cumprod(1.0 - a, dim=0)[:-1]], dim=0)
        contrib = t_before * a                          # (C, HW)
        feats = s.feats[idx][:, [0, 1, 2, 4]]           # r, g, b, z
        rgbd_b = contrib.T @ feats                      # (HW, 4)
        a_b = contrib.sum(dim=0)
        rgbd = rgbd + (1.0 - alpha)[:, None] * rgbd_b
        alpha = alpha + (1.0 - alpha) * a_b

    image = rgbd[:, :3] + (1.0 - alpha)[:, None] * background[None, :]
    image = torch.clamp(image, 0.0, 1.0).reshape(height, width, 3)
    depth = torch.clamp(rgbd[:, 3] / (alpha + 1e-6), min=0.0)
    return image, alpha.reshape(height, width), depth.reshape(height, width)

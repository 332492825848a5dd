"""Multiview fitting loss: L1 recon + silhouette + depth + D-SSIM +
regularisers, as `tpu_gaussians.fit.loss`.

Semantics contract (fit_multiview_stub.py:277-308):

  per view i:
    recon_i = mean|pred_i - target_i|
    sil_i   = mean|alpha_i - mask_i|                (if masks given)
    d_pred  = depth_i / (max(depth_i) + 1e-6)
    depth_i = mean|d_pred - depth_gt_i|             (if depth maps given)
    loss_i  = recon_i + silhouette_weight*sil_i + ssim_weight*(1 - ssim_i)
              + depth_weight*depth_i
  loss = mean_i(loss_i) + reg_opacity*mean(opacities) + reg_scale*mean(scales)

The views are rendered in turn; the parameter means average over alive
Gaussians only (the capacity mask replaces dynamic N).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_gaussians_torch.core.types import Camera, Gaussians, RenderConfig
from tpu_gaussians_torch.models.gaussian_model import RawParams, activate
from tpu_gaussians_torch.ops.dispatch import render_accum, render_sorted

STATS = ("dropped_pairs", "full_tiles", "clipped_rect_pairs")


@dataclass(frozen=True)
class LossConfig:
    """Loss weights; defaults match the reference CLI
    (fit_multiview_stub.py:222-227). ssim_weight is the 3DGS-style D-SSIM
    extension; 0.0 keeps exact reference semantics."""

    silhouette_weight: float = 0.2
    depth_weight: float = 0.05
    reg_opacity: float = 0.001
    reg_scale: float = 0.001
    ssim_weight: float = 0.0


def render_views(
    g: Gaussians,
    cameras: Camera,
    render_config: RenderConfig,
    row0: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Each view rendered in turn -> (pred (V,H,W,3), alpha (V,H,W), depth
    (V,H,W), the binner's overflow counters summed over views). row0: the
    row window [row0, row0 + height) of frames of proj_height rows
    (ops/dispatch.render_accum)."""
    render_view = render_sorted if render_config.mode == "sorted" \
        else render_accum
    outs = [render_view(g, cameras.view[i], cameras.proj[i], render_config,
                        row0=row0, return_stats=True)
            for i in range(cameras.num_views())]
    pred, alpha, depth = (torch.stack([o[j] for o in outs]) for j in range(3))
    stats = {k: sum(o[3][k] for o in outs).to(torch.float32) for k in STATS}
    return pred, alpha, depth, stats


def view_terms(
    pred: torch.Tensor, alpha: torch.Tensor, depth: torch.Tensor,
    targets: torch.Tensor, masks: Optional[torch.Tensor],
    depths: Optional[torch.Tensor], loss_config: LossConfig,
) -> Dict[str, torch.Tensor]:
    """The per-view terms of whole frames, each (V,): loss_i ("per_view")
    and its parts recon, silhouette, ssim and depth (zeros where off)."""
    recon = (pred - targets).abs().mean(dim=(1, 2, 3))        # (V,)
    per_view = recon
    zeros = torch.zeros_like(recon)

    sil = zeros
    if masks is not None and loss_config.silhouette_weight > 0.0:
        sil = (alpha - masks).abs().mean(dim=(1, 2))
        per_view = per_view + loss_config.silhouette_weight * sil

    ssim_v = zeros
    if loss_config.ssim_weight > 0.0:
        ssim_v = ssim(pred, targets)
        per_view = per_view + loss_config.ssim_weight * (1.0 - ssim_v)

    dl = zeros
    if depths is not None and loss_config.depth_weight > 0.0:
        d_max = depth.amax(dim=(1, 2), keepdim=True)
        dl = (depth / (d_max + 1e-6) - depths).abs().mean(dim=(1, 2))
        per_view = per_view + loss_config.depth_weight * dl
    return {"per_view": per_view, "recon": recon, "silhouette": sil,
            "ssim": ssim_v, "depth": dl}


def regularizer(g: Gaussians, loss_config: LossConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reg, n_alive): the opacity and scale means over alive gaussians."""
    alive = g.alive_mask()
    n_alive = torch.clamp(alive.sum(), min=1.0)
    mean_op = (g.opacities * alive).sum() / n_alive
    mean_scale = (g.scales * alive[:, None]).sum() / (n_alive * 3.0)
    reg = (loss_config.reg_opacity * mean_op
           + loss_config.reg_scale * mean_scale)
    return reg, n_alive


def loss_fn(
    raw: RawParams,
    cameras: Camera,
    targets: torch.Tensor,                # (V, H, W, 3)
    masks: Optional[torch.Tensor],        # (V, H, W) or None
    depths: Optional[torch.Tensor],       # (V, H, W) or None
    render_config: RenderConfig,
    loss_config: LossConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar loss (differentiable in raw's leaves) and a metrics dict of
    detached scalars. render_config.mode selects the compositing model."""
    g = activate(raw)
    pred, alpha, depth, stats = render_views(g, cameras, render_config)
    terms = view_terms(pred, alpha, depth, targets, masks, depths,
                       loss_config)
    reg, n_alive = regularizer(g, loss_config)
    loss = terms["per_view"].mean() + reg

    metrics = {
        "loss": loss, "recon": terms["recon"].mean(),
        "silhouette": terms["silhouette"].mean(),
        "depth": terms["depth"].mean(), "reg": reg,
        "psnr": psnr(pred, targets), "ssim": terms["ssim"].mean(),
        "n_alive": n_alive,
        # Binner overflow counters summed over views (zeros on the exact
        # accumulation paths).
        **{f"binner_{k}": v for k, v in stats.items()},
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return psnr_of_mse(((pred - target) ** 2).mean())


def psnr_of_mse(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _gauss_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable gaussian filter over (B, H, W), VALID padding. A cuDNN
    convolution on the card, kept true f32 by core.types.resolve_device
    (TF32 off), as the JAX side's precision="highest"."""
    size = k.shape[0]
    x = F.conv2d(x[:, None], k.reshape(1, 1, size, 1))
    return F.conv2d(x, k.reshape(1, 1, 1, size))[:, 0]


def ssim(pred: torch.Tensor, target: torch.Tensor, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Per-view SSIM of (V, H, W, 3) batches (11x11 gaussian window, C1/C2
    for unit dynamic range). Differentiable."""
    v = pred.shape[0]
    k = _gauss_kernel(size, sigma, pred.device)
    p = pred.permute(0, 3, 1, 2).reshape(-1, *pred.shape[1:3])
    t = target.permute(0, 3, 1, 2).reshape(-1, *target.shape[1:3])
    mu_p = _blur(p, k)
    mu_t = _blur(t, k)
    mu_pp = _blur(p * p, k) - mu_p * mu_p
    mu_tt = _blur(t * t, k) - mu_t * mu_t
    mu_pt = _blur(p * t, k) - mu_p * mu_t
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)) / (
        (mu_p * mu_p + mu_t * mu_t + c1) * (mu_pp + mu_tt + c2))
    return s.reshape(v, -1).mean(dim=1)

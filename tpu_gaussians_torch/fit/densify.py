"""Densify & prune at fixed capacity, as `tpu_gaussians.fit.densify`.

Reproduces the reference algorithm (fit_multiview_stub.py:140-197
`_densify_and_prune`) on fixed-capacity tensors with an alive mask:

  prune:   keep alive rows with sigmoid(op_raw) > prune_opacity; if fewer
           than min_keep (64) survive, keep the top-min(64, n_alive) by
           opacity (:153-157)
  compact: survivors move to the front, order preserved (:159-163)
  densify: add_n = min(capacity - n, floor(n * densify_ratio)) (:166-167);
           clone the top-add_n ranked Gaussians with positional jitter
           jitter_scale * scales * noise (:170-172), child op_raw -= 0.1
           (:174); rows past capacity are dropped
  split:   (3DGS extension, off by default) cloned Gaussians whose max
           activated scale exceeds split_scale_thresh are split instead:
           parent and child scales shrink by split_shrink and the child
           keeps the parent opacity

The jitter `noise` (C, 3) standard normals is an argument: the trainer
draws it from its torch.Generator, and a test can pass the JAX package's
own draw. Clone ranking: "opacity" (reference) or "grad" (the accumulated
positional-gradient norm per step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from tpu_gaussians_torch.models.gaussian_model import RawParams


@dataclass(frozen=True)
class DensifyConfig:
    """Defaults match the reference CLI (fit_multiview_stub.py:217-220)."""

    densify_interval: int = 80
    prune_interval: int = 80
    densify_ratio: float = 0.15
    prune_opacity: float = 0.05
    min_keep: int = 64            # survivor floor (:154-157)
    clone_metric: str = "opacity"  # "opacity" (reference) | "grad"
    jitter_scale: float = 0.25     # positional jitter factor (:171)
    split_scale_thresh: float = 0.0  # 3DGS split threshold; 0 = off
    split_shrink: float = 1.6        # 3DGS split scale divisor


def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    """softplus^-1 on positive y: y + log1p(-exp(-y)), stable for y > 0."""
    y = torch.clamp(y, min=1e-6)
    return y + torch.log1p(-torch.exp(-y))


def _scatter(base: Optional[torch.Tensor], dest: torch.Tensor,
             write: torch.Tensor, vals: Optional[torch.Tensor]):
    """base with rows dest[write] set to vals[write] (others dropped)."""
    if base is None:
        return None
    out = base.clone()
    out[dest[write]] = vals[write]
    return out


@torch.no_grad()
def densify_and_prune(
    raw: RawParams,
    noise: torch.Tensor,
    config: DensifyConfig,
    *,
    densify_ratio: Optional[float] = None,
    grad_norm_accum: Optional[torch.Tensor] = None,
    grad_steps: Optional[torch.Tensor] = None,
) -> Tuple[RawParams, Dict[str, torch.Tensor]]:
    """One densify/prune pass -> (new raw, stats). `densify_ratio`
    overrides the config value (the reference zeroes it when only the
    prune interval fires, fit_multiview_stub.py:322)."""
    ratio = config.densify_ratio if densify_ratio is None else densify_ratio
    c = raw.capacity
    dev = raw.device
    if grad_norm_accum is None:
        grad_norm_accum = torch.zeros((c,), dtype=torch.float32, device=dev)
    if grad_steps is None:
        grad_steps = torch.zeros((), dtype=torch.int32, device=dev)
    if tuple(noise.shape) != (c, 3):
        raise ValueError(f"noise must be ({c}, 3), got {tuple(noise.shape)}")
    j = torch.arange(c, device=dev)

    alive = raw.alive_mask() > 0.5
    op = torch.sigmoid(raw.opacities_raw)
    op_rank = torch.where(alive, op, torch.full_like(op, -1.0))

    # --- prune with survivor floor ---
    n_alive = alive.sum()
    keep_thresh = alive & (op > config.prune_opacity)
    pos = torch.empty_like(j)
    pos[torch.argsort(-op_rank, stable=True)] = j   # rank of each row
    top = (pos < torch.clamp(n_alive, max=config.min_keep)) & alive
    keep = top if int(keep_thresh.sum()) < config.min_keep else keep_thresh
    n = keep.sum()

    # --- order-preserving compaction: survivors to the front ---
    order = torch.argsort((~keep).to(torch.int8), stable=True)

    def gather(t):
        return None if t is None else t.detach()[order]

    means, scales_raw, op_raw = (gather(raw.means), gather(raw.scales_raw),
                                 gather(raw.opacities_raw))
    colors_raw, sh_raw, quats_raw = (gather(raw.colors_raw),
                                     gather(raw.sh_raw),
                                     gather(raw.quats_raw))
    alive_new = j < n

    # --- clone selection ---
    if config.clone_metric == "grad":
        steps = torch.clamp(grad_steps.to(torch.float32), min=1.0)
        metric = grad_norm_accum[order] / steps
    else:
        metric = torch.sigmoid(op_raw)
    metric = torch.where(alive_new, metric, torch.full_like(metric, -1.0))
    add_n = torch.clamp(torch.minimum(
        c - n, torch.floor(n.to(torch.float32) * ratio).to(n.dtype)), min=0)

    src = torch.argsort(-metric, stable=True)     # best-first source rows
    write = j < add_n
    dest = n + j                                  # write rows n .. n+add_n

    scales_act = torch.nn.functional.softplus(scales_raw) + 1e-3
    child_means = means[src] + config.jitter_scale * scales_act[src] * noise
    child_scales_raw = scales_raw[src]
    child_op_raw = op_raw[src] - 0.1
    if config.split_scale_thresh > 0.0:
        split = scales_act[src].amax(dim=1) > config.split_scale_thresh
        shrunk = _inv_softplus(torch.clamp(
            scales_act[src] / config.split_shrink - 1e-3, min=1e-6))
        child_scales_raw = torch.where(split[:, None], shrunk,
                                       child_scales_raw)
        child_op_raw = torch.where(split, op_raw[src], child_op_raw)
        scales_raw = _scatter(scales_raw, src, write & split, shrunk)

    new_raw = RawParams(
        means=_scatter(means, dest, write, child_means),
        scales_raw=_scatter(scales_raw, dest, write, child_scales_raw),
        opacities_raw=_scatter(op_raw, dest, write, child_op_raw),
        colors_raw=_scatter(colors_raw, dest, write,
                            None if colors_raw is None else colors_raw[src]),
        sh_raw=_scatter(sh_raw, dest, write,
                        None if sh_raw is None else sh_raw[src]),
        alive=(j < n + add_n).to(torch.float32),
        quats_raw=_scatter(quats_raw, dest, write,
                           None if quats_raw is None else quats_raw[src]),
    )
    stats = {"n_before": n_alive.to(torch.int32),
             "n_pruned": (n_alive - n).to(torch.int32),
             "n_cloned": add_n.to(torch.int32),
             "n_after": (n + add_n).to(torch.int32)}
    return new_raw, stats

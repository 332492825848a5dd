"""Plain PyTorch reference of one training step of depth-sorted Gaussian
splatting: the loss, its gradient and Adam, as the fit traffic states them.

Raw leaves (the trainer's parameterisation): means, scales_raw,
opacities_raw, sh_raw (N, rows, 3), and quats_raw for the EWA footprint;
the footprint and SH basis are the configuration's. Activated: scales =
softplus(scales_raw) + 1e-3, opacities = sigmoid(opacities_raw).
Loss over the step's V views:
  mean_v(mean|image_v - target_v| + w_sil mean|alpha_v - mask_v|)
  + reg_opacity mean(opacities) + reg_scale mean(scales)
Adam (lr, betas (0.9, 0.999), eps 1e-8, bias-corrected):
  p -= lr m_hat / (sqrt(v_hat) + eps).

The gradient of a frame is taken in two passes that fit the card: the
frame composited without gradient gives the loss's cotangent per pixel,
then each batch of tiles is composited again under autograd and
back-propagated with its slice of that cotangent into the per-gaussian
screen rows, which are back-propagated once into the leaves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from gsbench.reference import render as R

LEAVES = ("means", "scales_raw", "opacities_raw", "sh_raw", "quats_raw")


def leaves(raw: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """The trainable leaves raw holds, in LEAVES' order."""
    return tuple(k for k in LEAVES if k in raw)


def activate(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    g = {"means": raw["means"],
         "scales": torch.nn.functional.softplus(raw["scales_raw"]) + 1e-3,
         "opacities": torch.sigmoid(raw["opacities_raw"]),
         "sh": raw["sh_raw"]}
    if "quats_raw" in raw:
        g["quats"] = raw["quats_raw"]
    return g


def view_loss_and_cotangent(acc: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor, background, w_sil: float,
                            n_views: int) -> Tuple[float, torch.Tensor]:
    """(this view's share of the loss, d loss / d acc (H, W, 5))."""
    leaf = acc.detach().requires_grad_(True)
    image = R.resolve(leaf, background)
    term = (image - target).abs().mean()
    if w_sil > 0:
        term = term + w_sil * (leaf[..., 3] - mask).abs().mean()
    term = term / n_views
    term.backward()
    return float(term.detach()), leaf.grad


def reference_step(raw: Dict[str, torch.Tensor], views: torch.Tensor,
                   projs: torch.Tensor, targets: torch.Tensor,
                   masks: torch.Tensor, spec: dict, pair_k: int, cap: int,
                   tile_batch: int = 16
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, gradient by leaf) of one step over views (V, 4, 4); spec
    holds the frame size, the loss weights, the background, the exit
    threshold and the configuration (spec["config"])."""
    width, height = spec["width"], spec["height"]
    loss_w = spec["loss"]
    bg = spec["background"]
    exit_t = spec["exit_t"]
    names = leaves(raw)
    params = {k: raw[k].detach().clone().requires_grad_(True) for k in names}
    g = activate(params)
    tx_n, ty_n = R.tiles_of(width, height)
    n_views = views.shape[0]
    total = 0.0
    grads_rows = []
    rows_all = []
    for v in range(n_views):
        st = R.screen_stage(g, views[v], projs[v], width, height,
                            spec["config"])
        rows = R.rows_table(st)
        slots, counts = R.tile_lists(st, width, height, pair_k, cap)
        acc, _ = R.composite_frame(rows.detach(), slots, counts, width,
                                   height, exit_t=exit_t)
        part, cot = view_loss_and_cotangent(
            acc, targets[v], masks[v], bg, loss_w["silhouette_weight"],
            n_views)
        total += part
        # The cotangent laid out by tile: (n_tiles, 5, TPS), zero outside
        # the frame.
        pad = torch.zeros((ty_n * R.TH, tx_n * R.TW, 5), device=cot.device)
        pad[:height, :width] = cot
        cot_t = pad.reshape(ty_n, R.TH, tx_n, R.TW, 5).permute(
            0, 2, 4, 1, 3).reshape(tx_n * ty_n, 5, R.TPS)
        leaf_rows = rows.detach().requires_grad_(True)
        for t0 in range(0, tx_n * ty_n, tile_batch):
            ids = torch.arange(t0, min(t0 + tile_batch, tx_n * ty_n),
                               device=rows.device)
            used = int(counts[ids].max())
            if used == 0:
                continue
            out, _ = R.composite_tiles(leaf_rows, slots[ids], ids, tx_n,
                                       used, width, height, exit_t=exit_t)
            (out * cot_t[ids]).sum().backward()
        rows_all.append(rows)
        grads_rows.append(leaf_rows.grad)
    reg = (loss_w["reg_opacity"] * g["opacities"].mean()
           + loss_w["reg_scale"] * g["scales"].mean())
    total += float(reg.detach())
    surrogate = reg + sum((r * gr).sum() for r, gr in zip(rows_all, grads_rows)
                          if gr is not None)
    surrogate.backward()
    return total, {k: params[k].grad.detach() for k in names}


class Adam:
    """Adam over the leaves, bias-corrected, as torch and optax compute it."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, raw: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        out = {}
        for k, gk in grads.items():
            m = self.m.get(k, torch.zeros_like(gk))
            v = self.v.get(k, torch.zeros_like(gk))
            self.m[k] = m = self.b1 * m + (1 - self.b1) * gk
            self.v[k] = v = self.b2 * v + (1 - self.b2) * gk * gk
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            out[k] = raw[k] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        return {**raw, **out}


def reference_steps(raw0: Dict[str, torch.Tensor], batches: List[tuple],
                    spec: dict, pair_k: int, cap: int
                    ) -> Tuple[List[float], Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """The first len(batches) steps from raw0 -> (losses, first step's
    gradient by leaf, parameters after the last step). Each batch is
    (views, projs, targets, masks)."""
    adam = Adam(spec["lr"])
    raw = {k: raw0[k].clone() for k in leaves(raw0)}
    losses, first = [], None
    for views, projs, targets, masks in batches:
        loss, grads = reference_step(raw, views, projs, targets, masks, spec,
                                     pair_k, cap)
        losses.append(loss)
        first = grads if first is None else first
        raw = adam.step(raw, grads)
    return losses, first, raw

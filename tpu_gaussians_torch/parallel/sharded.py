"""Sharded training steps: views (and rows) over ranks, parameters whole on
every rank, as `tpu_gaussians.parallel.sharded`.

The per-step computation is the single-device step's (fit/step.py):
  grads = (1/V) * sum_v grad(loss_v)       [+ the regulariser's term]
Each rank renders its V / n_views views, computes its local loss and its
gradients, and one all-reduce of a flat buffer (every gradient and the
metrics together: gloo stages CUDA tensors through the host, a call per
leaf would pay its latency per leaf) averages them before Adam. Adam then
runs the same on every rank, so the parameters stay equal on every rank.

Row sharding (`shard_rows` on a mesh with rows > 1) renders each view as
row windows, a window a rank (ops/dispatch.py row0 / proj_height; whole
tile rows, parallel/mesh.band_rows, so that a window's tiles are the
frame's and the binner drops the same pairs as in the frame). The loss
needs whole frames (the SSIM window and the per-view means cross window
edges), so an autograd Function builds each frame by an all-reduce (sum)
of zero-padded windows over the row group; its backward keeps the rank's
own rows of the incoming gradient, with no communication. Every rank of a
row group then computes the same loss, and the gradients are summed over
rows and averaged over views.

Metrics equal the single-device step's: means over views (loss, recon,
silhouette, depth, ssim) are averaged over ranks, psnr comes from the
averaged MSE, the binner counters are summed, and reg, n_alive and
grad_norm_mean come from state that is equal on every rank or from the
reduced gradients.

`allreduce` counts the calls and bytes each rank sends and the host
milliseconds spent in the calls and their waits (under gloo on CUDA
tensors these include waiting for the device work that feeds the copy).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tpu_gaussians_torch.core.types import Camera, RenderConfig
from tpu_gaussians_torch.fit.loss import (
    STATS, LossConfig, psnr_of_mse, regularizer, render_views, view_terms)
from tpu_gaussians_torch.fit.step import Optimizer, TrainState, adam_update
from tpu_gaussians_torch.models.gaussian_model import activate
from tpu_gaussians_torch.parallel.mesh import (
    ROW_AXIS, VIEW_AXIS, Mesh, band_rows, view_sharding)
from tpu_gaussians_torch.utils.profiling import annotate

allreduce = {"calls": 0, "bytes": 0, "ms": 0.0}

MEAN_KEYS = ("data", "recon", "silhouette", "depth", "ssim", "mse")
SUM_KEYS = tuple(f"binner_{k}" for k in STATS)


def reset_allreduce() -> None:
    allreduce.update(calls=0, bytes=0, ms=0.0)


def _all_reduce(buf: torch.Tensor, group: Optional[dist.ProcessGroup],
                async_op: bool = False):
    """Sum `buf` in place over `group` (nothing to do without one);
    returns the pending work when async_op."""
    if group is None:
        return None
    t0 = time.perf_counter()
    work = dist.all_reduce(buf, group=group, async_op=async_op)
    allreduce["calls"] += 1
    allreduce["bytes"] += buf.numel() * buf.element_size()
    allreduce["ms"] += (time.perf_counter() - t0) * 1e3
    return work


def _wait(work) -> None:
    t0 = time.perf_counter()
    work.wait()
    allreduce["ms"] += (time.perf_counter() - t0) * 1e3


class _AssembleRows(torch.autograd.Function):
    """(v, band, W, C) row windows at row0 -> (v, height, W, C) whole
    frames, summed over the row group; the backward keeps the window's own
    rows of the gradient."""

    @staticmethod
    def forward(ctx, window, row0: int, height: int, group):
        n = max(0, min(window.shape[1], height - row0))
        full = window.new_zeros((window.shape[0], height) + window.shape[2:])
        full[:, row0:row0 + n] = window[:, :n]
        _all_reduce(full, group)
        ctx.row0, ctx.n, ctx.band = row0, n, window.shape[1]
        return full

    @staticmethod
    def backward(ctx, grad):
        g = grad.new_zeros((grad.shape[0], ctx.band) + grad.shape[2:])
        g[:, :ctx.n] = grad[:, ctx.row0:ctx.row0 + ctx.n]
        return g, None, None, None


def _make_step(render_config: RenderConfig, loss_config: LossConfig,
               has_masks: bool, has_depths: bool, mesh: Mesh,
               shard_rows: bool, n_chunks: int):
    n_views, n_rows = mesh.shape[VIEW_AXIS], mesh.shape[ROW_AXIS]
    rows = shard_rows and n_rows > 1
    # Summed over ranks, then: gradients are a sum over row windows and a
    # mean over view shards; without row windows the ranks of a row group
    # are replicas, so everything is a mean over all ranks.
    grad_scale = 1.0 / (n_views if rows else mesh.size)
    mean_scale = 1.0 / mesh.size
    sum_scale = 1.0 if rows else 1.0 / n_rows
    reg_share = 1.0 / n_rows if rows else 1.0
    band = band_rows(render_config.height, n_rows)
    band_config = render_config.replace(
        height=band, proj_height=render_config.full_height())

    def chunk_loss(raw, view, proj, targets, masks, depths):
        g = activate(raw)
        cams = Camera(view=view, proj=proj)
        if rows:
            row0 = mesh.coords[1] * band
            pred, alpha, depth, stats = render_views(g, cams, band_config,
                                                     row0=float(row0))
            full = _AssembleRows.apply(
                torch.cat([pred, alpha[..., None], depth[..., None]], -1),
                row0, render_config.height, mesh.row_group)
            pred, alpha, depth = full[..., :3], full[..., 3], full[..., 4]
        else:
            pred, alpha, depth, stats = render_views(g, cams, render_config)
        terms = view_terms(pred, alpha, depth, targets,
                           masks if has_masks else None,
                           depths if has_depths else None, loss_config)
        reg, n_alive = regularizer(g, loss_config)
        data = terms["per_view"].mean()
        local = {"data": data, "mse": ((pred - targets) ** 2).mean(),
                 **{k: terms[k].mean() for k in MEAN_KEYS[1:5]},
                 **{f"binner_{k}": v for k, v in stats.items()}}
        return data + reg_share * reg, local, reg, n_alive

    def step(state: TrainState, cameras: Camera, targets: torch.Tensor,
             masks: torch.Tensor, depths: torch.Tensor,
             means_lr_scale: float = 1.0
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with annotate("gs.fit.step", root=True):
            v = targets.shape[0]
            if v % n_views:
                raise ValueError(f"{v} views do not split into {n_views} "
                                 "equal view shards")
            shard3, shard4 = view_sharding(mesh, 3), view_sharding(mesh, 4)
            view, proj = shard3.local(cameras.view), shard3.local(cameras.proj)
            targets, masks, depths = (shard4.local(targets),
                                      shard3.local(masks),
                                      shard3.local(depths))
            v_local = targets.shape[0]
            k = max(1, min(n_chunks, v_local))
            while v_local % k:
                k -= 1                  # equal chunks: the mean of chunk means
            cv = v_local // k
            leaves = state.raw.trainable()
            names = list(leaves)
            pending = []
            for c in range(k):
                sl = slice(c * cv, (c + 1) * cv)
                loss_c, local, reg, n_alive = chunk_loss(
                    state.raw, view[sl], proj[sl], targets[sl], masks[sl],
                    depths[sl])
                with annotate("gs.fit.backward"):
                    grads = torch.autograd.grad(
                        loss_c, [leaves[n] for n in names], allow_unused=True)
                buf = torch.cat(
                    [(torch.zeros_like(leaves[n]) if gr is None
                      else gr).reshape(-1) for n, gr in zip(names, grads)]
                    + [local[m].detach().reshape(1).to(torch.float32)
                       for m in MEAN_KEYS + SUM_KEYS])
                # Chunk c's all-reduce runs while chunk c + 1 renders.
                pending.append((buf, _all_reduce(buf, mesh.group,
                                                 async_op=True)))
            for _, work in pending:
                if work is not None:
                    _wait(work)
            total = pending[0][0] if k == 1 else torch.stack(
                [b for b, _ in pending]).sum(0)
            n_grad = total.numel() - len(MEAN_KEYS) - len(SUM_KEYS)
            grad_flat = total[:n_grad] * (grad_scale / k)
            means_ = total[n_grad:n_grad + len(MEAN_KEYS)] * (mean_scale / k)
            sums = total[n_grad + len(MEAN_KEYS):] * sum_scale
            at = 0
            for n in names:
                t = leaves[n]
                t.grad = grad_flat[at:at + t.numel()].view_as(t).clone()
                at += t.numel()
            gnorm = torch.linalg.vector_norm(leaves["means"].grad, dim=1)
            adam_update(state, means_lr_scale)
            state.grad_norm_accum += gnorm
            state.grad_steps += 1
            m = dict(zip(MEAN_KEYS, means_))
            metrics = {
                "loss": m["data"] + reg.detach(), "recon": m["recon"],
                "silhouette": m["silhouette"], "depth": m["depth"],
                "reg": reg.detach(), "psnr": psnr_of_mse(m["mse"]),
                "ssim": m["ssim"], "n_alive": n_alive.detach(),
                **dict(zip(SUM_KEYS, sums)), "grad_norm_mean": gnorm.mean()}
            return state, metrics

    return step


def make_sharded_train_step(
    tx: Optimizer,
    render_config: RenderConfig,
    loss_config: LossConfig,
    has_masks: bool,
    has_depths: bool,
    mesh: Mesh,
    shard_rows: bool = False,
):
    """The train step with views (and, with shard_rows, image rows) over
    the mesh's ranks: one all-reduce after the backward over the local
    views (JAX's GSPMD step, whose collective XLA places).

    Argument layout matches fit.step.make_train_step's step:
      (state, cameras, targets (V,H,W,3), masks (V,H,W), depths (V,H,W)
       [, means_lr_scale]),
    the global arrays, the same on every rank; each rank takes its views
    (view_sharding). The state is whole on every rank and updated in place.
    `tx` is the optimizer factory the state was built with (init_state).
    """
    del tx
    return _make_step(render_config, loss_config, has_masks, has_depths,
                      mesh, shard_rows, n_chunks=1)


def make_shardmap_train_step(
    tx: Optimizer,
    render_config: RenderConfig,
    loss_config: LossConfig,
    has_masks: bool,
    has_depths: bool,
    mesh: Mesh,
):
    """Explicit-collective variant (JAX's shard_map step with a hand-placed
    pmean over "views"): per-rank local loss and gradients, their mean over
    the view shards. On torch.distributed every step places its collective
    by hand, so this is make_sharded_train_step without row sharding, and
    make_overlapped_train_step with one chunk."""
    del tx
    return _make_step(render_config, loss_config, has_masks, has_depths,
                      mesh, False, n_chunks=1)


def make_overlapped_train_step(
    tx: Optimizer,
    render_config: RenderConfig,
    loss_config: LossConfig,
    has_masks: bool,
    has_depths: bool,
    mesh: Mesh,
    n_chunks: int = 4,
):
    """The gradient all-reduce overlapped with the next chunk's render
    (JAX's chunked pmean). The local views split into at most `n_chunks`
    equal groups; each runs its own forward and backward and sends its
    gradients at once (all_reduce with async_op) while the next group
    renders. Every work is waited on before Adam. The final gradient is the
    mean of the chunk means, equal to the one-chunk step's in real
    arithmetic (equal chunks; the regulariser counted once on average)."""
    del tx
    return _make_step(render_config, loss_config, has_masks, has_depths,
                      mesh, False, n_chunks=n_chunks)

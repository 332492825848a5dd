"""Fitting orchestration, as `tpu_gaussians.fit.trainer` (reference:
fit_multiview_stub.main, :200-382).

Runs the train step in a plain loop, fires densify/prune on the
reference's intervals with its optimizer reset (:318-325), logs loss
(print cadence, loss.txt, metrics.jsonl) and writes the reference's
artifacts: gaussians_fitted.npz, loss.txt, preview_view0.png (:339-380).
The schedule is the JAX trainer's: the first step alone (its iter-1 log
line), then segments between host events, the positional lr decay
evaluated at each segment's start. Given an out_dir, it checkpoints every
`checkpoint_every` steps and, with `resume`, restarts from the latest
checkpoint there (io/checkpoint.py), appending to metrics.jsonl.

With num_view_shards > 1 it runs as one rank of a torch.distributed group
of exactly that many ranks (parallel/mesh.initialize_distributed; cli.fit
is launched under `python -m torch.distributed.run`): each rank renders
its share of the views through parallel/sharded's step, whose all-reduce
keeps the parameters equal on every rank. Densify and prune then act the
same on every rank (the jitter comes from a generator of the same seed);
only rank 0 prints the log and writes out_dir, with a barrier after each
write.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_gaussians_torch.core import camera as cam
from tpu_gaussians_torch.core.types import (
    Camera, Device, RenderConfig, resolve_device, to_device)
from tpu_gaussians_torch.fit.densify import DensifyConfig, densify_and_prune
from tpu_gaussians_torch.fit.loss import LossConfig
from tpu_gaussians_torch.fit.step import (
    init_state, make_optimizer, make_train_step)
from tpu_gaussians_torch.io import image as im
from tpu_gaussians_torch.io.checkpoint import Checkpointer
from tpu_gaussians_torch.io.npz import load_gaussians_npz, save_raw_npz
from tpu_gaussians_torch.models.gaussian_model import (
    RawParams, activate, init_params, raw_from_gaussians)
from tpu_gaussians_torch.ops.dispatch import render
from tpu_gaussians_torch.ops.sorted import auto_pair_k
from tpu_gaussians_torch.parallel.mesh import make_mesh, rank_and_world
from tpu_gaussians_torch.parallel.sharded import make_sharded_train_step
from tpu_gaussians_torch.utils.config import FitConfig, resolve_render_mode

METRIC_KEYS = ("loss", "recon", "silhouette", "depth", "reg", "psnr",
               "ssim", "n_alive", "grad_norm_mean",
               "binner_dropped_pairs", "binner_full_tiles",
               "binner_clipped_rect_pairs")
MAX_SEG = 256   # longest run of steps between lr-decay updates


@dataclass
class FitResult:
    raw: RawParams
    loss_log: List[float]
    cameras: Camera
    wall_time_s: float


def load_dataset(config: FitConfig, device: Device = "cuda"):
    """Targets + optional masks/depths (numpy) + cameras (on `device`)."""
    paths = im.list_target_paths(config.targets_dir)
    targets = im.load_targets(paths, config.width, config.height)
    masks = im.load_optional_stem_matched(
        paths, config.masks_dir or None, config.width, config.height)
    if masks is None and config.silhouette_weight > 0.0:
        masks = im.estimate_masks(targets, config.mask_thresh)
    depths = im.load_optional_stem_matched(
        paths, config.depth_dir or None, config.width, config.height)
    if config.camera_npz:
        cameras = cam.load_cameras_npz(config.camera_npz, len(paths),
                                       device=device)
        if rank_and_world()[0] == 0:
            print("Using camera poses from camera_npz")
    else:
        cameras = cam.orbit_cameras(len(paths), config.width, config.height,
                                    device=device)
        if rank_and_world()[0] == 0:
            print("Using fallback orbit cameras (for best quality, provide "
                  "camera_npz)")
    return targets, masks, depths, cameras


def _barrier() -> None:
    if rank_and_world()[1] > 1:
        dist.barrier()


def _check_group(config: FitConfig, v: int) -> None:
    """The view count splits evenly, and a group of exactly
    num_view_shards ranks is up (none when it is 1)."""
    n = config.num_view_shards
    if v % n != 0:
        raise ValueError(f"num_view_shards={n} must divide view count {v}")
    world = rank_and_world()[1]
    if world != n:
        raise RuntimeError(
            f"num_view_shards={n} needs a torch.distributed group of "
            f"exactly {n} ranks, found {world} (1 without a group): launch "
            f"`python -m torch.distributed.run --nproc_per_node {n} -m "
            f"tpu_gaussians_torch.cli.fit ... --num_view_shards {n}`")


def fit(
    config: FitConfig,
    targets: np.ndarray,
    cameras: Camera,
    masks: Optional[np.ndarray] = None,
    depths: Optional[np.ndarray] = None,
    out_dir: Optional[Path] = None,
    device: Device = "cuda",
    raw0: Optional[RawParams] = None,
    densify_noise: Optional[Callable[[int], torch.Tensor]] = None,
) -> FitResult:
    """Run the fitting loop. targets (V,H,W,3); masks/depths (V,H,W).

    raw0 (the initial parameters) and densify_noise (it -> (C, 3) jitter
    draws for the densify event at iteration `it`) replace the draws from
    torch.Generator().manual_seed(config.seed), so that a test can start
    this package and the JAX one from identical arrays."""
    dev = resolve_device(device)
    v = targets.shape[0]
    _check_group(config, v)
    rank = rank_and_world()[0]
    say = print if rank == 0 else (lambda *a, **k: None)
    has_masks = masks is not None and config.silhouette_weight > 0.0
    has_depths = depths is not None and config.depth_weight > 0.0
    zeros = np.zeros((v, config.height, config.width), np.float32)
    targets_t = to_device(targets, dev)
    masks_t = to_device(masks if has_masks else zeros, dev)
    depths_t = to_device(depths if has_depths else zeros, dev)
    cameras = Camera(view=cameras.view.to(dev), proj=cameras.proj.to(dev))

    gen = torch.Generator().manual_seed(config.seed)
    capacity = max(config.max_gaussians, config.num_gaussians)
    if raw0 is not None:
        raw = raw0.to(dev)
        capacity = raw.capacity
    elif config.init_npz:
        g0 = load_gaussians_npz(config.init_npz, device=dev)
        capacity = max(capacity, int((g0.alive_mask() > 0.5).sum()))
        raw = raw_from_gaussians(g0, capacity)
        if raw.use_sh != bool(config.use_sh):
            raise ValueError(
                "--init_npz SH-ness must match --use_sh "
                f"(init has sh={raw.use_sh}, flag use_sh={config.use_sh})")
        say(f"Initialized {int(raw.num_alive())} gaussians from "
            f"{config.init_npz} (capacity {capacity})")
    else:
        raw = init_params(gen, config.num_gaussians, capacity,
                          config.use_sh, use_quats=config.footprint == "ewa",
                          sh_degree=config.sh_degree, device=dev)
    if densify_noise is None:
        def densify_noise(it):
            return torch.randn((capacity, 3), generator=gen).to(dev)

    mode = resolve_render_mode(config, capacity)
    pair_k = config.sorted_pair_k
    if mode == "sorted" and pair_k == 0 and config.impl != "torch":
        # The budget measured at init (the generic k_pairs formula
        # over-budgets real scenes); growth past it shows in the binner's
        # clipped_rect_pairs counter and the lossy-render warning below.
        pair_k = auto_pair_k(activate(raw), cameras.view, cameras.proj,
                             config.width, config.height,
                             footprint=config.footprint)
        say(f"sorted pair budget k={pair_k} (measured max rect, "
            f"auto; override with --sorted_pair_k)")
    render_config = RenderConfig(
        width=config.width, height=config.height, impl=config.impl,
        footprint=config.footprint, mode=mode,
        accum_binned=config.accum_binned,
        sorted_pair_k=pair_k, return_aux=True)
    loss_config = LossConfig(
        silhouette_weight=config.silhouette_weight,
        depth_weight=config.depth_weight, reg_opacity=config.reg_opacity,
        reg_scale=config.reg_scale, ssim_weight=config.ssim_weight)
    densify_config = DensifyConfig(
        densify_interval=config.densify_interval,
        prune_interval=config.prune_interval,
        densify_ratio=config.densify_ratio,
        prune_opacity=config.prune_opacity,
        clone_metric=config.clone_metric,
        split_scale_thresh=config.split_scale_thresh,
        split_shrink=config.split_shrink)

    tx = make_optimizer(config.lr)
    state = init_state(raw, tx)
    checkpointer = None
    start_iter = 0
    if out_dir is not None and (config.checkpoint_every > 0 or config.resume):
        # Rank 0 makes the directory and alone saves; every rank restores
        # the same checkpoint.
        if rank == 0:
            checkpointer = Checkpointer(Path(out_dir) / "checkpoints")
        _barrier()
        checkpointer = checkpointer or Checkpointer(
            Path(out_dir) / "checkpoints")
        if config.resume and checkpointer.latest_step() is not None:
            start_iter, state, gen_state = checkpointer.restore(tx, dev)
            gen.set_state(gen_state)
            say(f"Resumed from checkpoint at iter {start_iter}")
    if config.num_view_shards > 1:
        step_fn = make_sharded_train_step(
            tx, render_config, loss_config, has_masks, has_depths,
            make_mesh(config.num_view_shards, 1))
        say(f"Sharding {v} views over {config.num_view_shards} ranks")
    else:
        step_fn = make_train_step(render_config, loss_config, has_masks,
                                  has_depths)

    def means_lr_at(i: int) -> float:
        if config.means_lr_final >= 1.0 or config.iters <= 0:
            return 1.0
        return config.means_lr_final ** (i / config.iters)

    def next_event(it: int) -> int:
        nxt = config.iters
        for interval in (config.log_every, config.densify_interval,
                         config.prune_interval, config.checkpoint_every,
                         config.opacity_reset_interval):
            if interval > 0:
                nxt = min(nxt, ((it // interval) + 1) * interval)
        return nxt

    rows = []   # per-step metric rows, fetched from the device at the end
    warned_lossy = False   # warn once when a step's render dropped work
    t0 = time.perf_counter()
    last_log_t, last_log_it = t0, start_iter
    it, seg_end, mlr = start_iter, start_iter, 1.0
    while it < config.iters:
        if it == seg_end:   # a new segment: the lr decay is read here
            seg_end = (it + 1 if it == start_iter
                       else min(next_event(it), it + MAX_SEG))
            mlr = means_lr_at(it)
        state, metrics = step_fn(state, cameras, targets_t, masks_t,
                                 depths_t, means_lr_scale=mlr)
        rows.append(torch.stack([metrics[k].to(torch.float32)
                                 for k in METRIC_KEYS]))
        it += 1

        if it == start_iter + 1 or (config.log_every > 0
                                    and it % config.log_every == 0):
            lv, n = float(rows[-1][0]), int(rows[-1][METRIC_KEYS.index(
                "n_alive")])
            now = time.perf_counter()
            rate = v * config.width * config.height * max(
                it - last_log_it, 1) / max(now - last_log_t, 1e-9)
            last_log_t, last_log_it = now, it
            say(f"iter {it:4d}  loss={lv:.6f}  N={n}  "
                f"{rate / 1e6:.1f} Mpix/s")
            dropped = float(rows[-1][METRIC_KEYS.index(
                "binner_dropped_pairs")])
            clipped = float(rows[-1][METRIC_KEYS.index(
                "binner_clipped_rect_pairs")])
            if not warned_lossy and (dropped > 0 or clipped > 0):
                warned_lossy = True
                say(f"WARNING: this step's render dropped work to "
                    f"capacity/budget limits ({dropped:.0f} pairs at "
                    f"tile capacity, {clipped:.0f} rect-budget "
                    f"overlaps; conservative W_CULL extents in accum "
                    f"mode). Counters are in metrics.jsonl; raise "
                    f"tile capacity / use accum_binned=off if "
                    f"exactness matters.")

        densify_fires = (config.densify_interval > 0
                         and it % config.densify_interval == 0)
        prune_fires = (config.prune_interval > 0
                       and it % config.prune_interval == 0)
        if densify_fires or prune_fires:
            new_raw, _ = densify_and_prune(
                state.raw, densify_noise(it).to(dev), densify_config,
                densify_ratio=config.densify_ratio if densify_fires else 0.0,
                grad_norm_accum=state.grad_norm_accum,
                grad_steps=state.grad_steps)
            state = init_state(new_raw, tx)   # fresh Adam, :325

        if (config.opacity_reset_interval > 0
                and it % config.opacity_reset_interval == 0
                and it < config.iters):
            # 3DGS opacity reset: clamp op <= reset value (on the logit)
            # and drop the optimizer state so Adam does not undo it.
            rv = config.opacity_reset_value
            logit = math.log(rv) - math.log1p(-rv)
            state = init_state(state.raw.replace(opacities_raw=torch.clamp(
                state.raw.opacities_raw.detach(), max=logit)), tx)

        if (checkpointer is not None and config.checkpoint_every > 0
                and it % config.checkpoint_every == 0):
            if rank == 0:
                checkpointer.save(it, state, gen)
            _barrier()

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    hist = (torch.stack(rows).cpu().numpy() if rows
            else np.zeros((0, len(METRIC_KEYS)), np.float32))
    loss_log = [float(x) for x in hist[:, 0]]
    if out_dir is not None and config.metrics_jsonl and rows and rank == 0:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        # A resumed fit appends the steps it ran to the earlier ones.
        with (out_dir / "metrics.jsonl").open(
                "a" if start_iter > 0 else "w") as f:
            for i, row in enumerate(hist):
                f.write(json.dumps({"step": start_iter + i + 1, **{
                    k: float(x) for k, x in zip(METRIC_KEYS, row)}}) + "\n")
    _barrier()
    final = state.raw.with_trainable(
        {k: t.detach() for k, t in state.raw.trainable().items()})
    return FitResult(raw=final, loss_log=loss_log, cameras=cameras,
                     wall_time_s=wall)


def write_artifacts(out_dir: Path, result: FitResult,
                    config: FitConfig) -> None:
    """Emit the reference's artifacts (fit_multiview_stub.py:339-380); in
    a sharded fit rank 0 writes them, and every rank must call this."""
    if rank_and_world()[0] != 0:
        _barrier()
        return
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_raw_npz(out_dir / "gaussians_fitted.npz", result.raw)
    (out_dir / "loss.txt").write_text(
        "\n".join(f"{v:.8f}" for v in result.loss_log), encoding="utf-8")
    cam0 = result.cameras[0] if result.cameras.batched else result.cameras
    render_config = RenderConfig(width=config.width, height=config.height,
                                 impl=config.impl, footprint=config.footprint)
    with torch.no_grad():
        pred0 = render(activate(result.raw), cam0, render_config)
    im.save_image_png(out_dir / "preview_view0.png", pred0.cpu().numpy())
    _barrier()

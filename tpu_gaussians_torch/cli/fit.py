"""Multiview fitting CLI: the flags, names and defaults of
`tpu_gaussians.cli.fit` (the reference trainer's, fit_multiview_stub.py:
201-229, plus its extensions), with `--impl auto|torch|tiled` and
`--device` added.

Usage:
  python -m tpu_gaussians_torch.cli.fit --targets_dir assets/scene \
      --iters 300 [--device cuda]
  # views sharded over N ranks (data parallel; ranks may share a card):
  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m tpu_gaussians_torch.cli.fit --targets_dir assets/scene \
      --num_view_shards N
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

from tpu_gaussians_torch.core.types import resolve_device
from tpu_gaussians_torch.fit.trainer import fit, load_dataset, write_artifacts
from tpu_gaussians_torch.ops.binned import BINNED_MIN_N
from tpu_gaussians_torch.parallel import sharded
from tpu_gaussians_torch.parallel.mesh import (
    initialize_distributed, rank_and_world)
from tpu_gaussians_torch.utils.profiling import launch_counts
from tpu_gaussians_torch.utils.config import FitConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    d = FitConfig()
    ap.add_argument("--targets_dir", required=True,
                    help="Directory containing target images")
    ap.add_argument("--out_dir", default=d.out_dir)
    ap.add_argument("--camera_npz", default="",
                    help="Optional camera file with view/proj arrays")
    ap.add_argument("--masks_dir", default="",
                    help="Optional silhouette masks dir (same stem as targets, PNG)")
    ap.add_argument("--depth_dir", default="",
                    help="Optional depth maps dir (same stem as targets, PNG normalized)")

    ap.add_argument("--iters", type=int, default=d.iters)
    ap.add_argument("--lr", type=float, default=d.lr)
    ap.add_argument("--width", type=int, default=d.width)
    ap.add_argument("--height", type=int, default=d.height)
    ap.add_argument("--num_gaussians", type=int, default=d.num_gaussians)
    ap.add_argument("--max_gaussians", type=int, default=d.max_gaussians)

    ap.add_argument("--use_sh", action="store_true",
                    help="Use SH degree-1 color (N,4,3) instead of RGB")
    ap.add_argument("--sh_degree", type=int, default=d.sh_degree,
                    choices=[1, 2, 3],
                    help="SH degree with --use_sh: 1 = reference "
                         "convention; 2/3 = standard 3DGS real SH")

    ap.add_argument("--densify_interval", type=int, default=d.densify_interval)
    ap.add_argument("--prune_interval", type=int, default=d.prune_interval)
    ap.add_argument("--densify_ratio", type=float, default=d.densify_ratio)
    ap.add_argument("--prune_opacity", type=float, default=d.prune_opacity)

    ap.add_argument("--ssim_weight", type=float, default=d.ssim_weight,
                    help="3DGS-style D-SSIM loss weight (0 = reference "
                         "L1-only)")
    ap.add_argument("--silhouette_weight", type=float, default=d.silhouette_weight)
    ap.add_argument("--mask_thresh", type=float, default=d.mask_thresh)
    ap.add_argument("--depth_weight", type=float, default=d.depth_weight)

    ap.add_argument("--reg_opacity", type=float, default=d.reg_opacity)
    ap.add_argument("--reg_scale", type=float, default=d.reg_scale)

    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--impl", choices=["auto", "torch", "tiled"],
                    default=d.impl,
                    help="auto/tiled = the CUDA kernels; torch = the plain "
                         "whole-frame renderer")
    ap.add_argument("--footprint", choices=["axis", "ewa"], default=d.footprint,
                    help="axis = reference-parity footprint; ewa = "
                         "trainable quaternion + full covariance")
    ap.add_argument("--render_mode", choices=["auto", "accum", "sorted"],
                    default=d.render_mode,
                    help="auto = footprint-aware (ewa at >= 4096 capacity "
                         "trains sorted, otherwise accum); accum = "
                         "reference weighted-average training; sorted = "
                         "depth-sorted alpha blending")
    ap.add_argument("--accum_binned", choices=["auto", "on", "off"],
                    default=d.accum_binned,
                    help="accum kernels: auto = tile-binned lists for the "
                         f"ewa footprint at n >= {BINNED_MIN_N} gaussians, "
                         "dense band kernels below it and always for the "
                         "axis footprint; off = dense band kernels; on = "
                         "tile-binned lists")
    ap.add_argument("--clone_metric", choices=["opacity", "grad"],
                    default=d.clone_metric)
    ap.add_argument("--split_scale_thresh", type=float,
                    default=d.split_scale_thresh,
                    help="3DGS split: clone sources with max world scale "
                         "above this are split (parent+child shrunk by "
                         "--split_shrink); 0 disables (reference behavior)")
    ap.add_argument("--split_shrink", type=float, default=d.split_shrink)
    ap.add_argument("--opacity_reset_interval", type=int,
                    default=d.opacity_reset_interval,
                    help="3DGS: clamp opacities to <= --opacity_reset_value "
                         "every N iters; 0 disables (reference behavior)")
    ap.add_argument("--opacity_reset_value", type=float,
                    default=d.opacity_reset_value)
    ap.add_argument("--init_npz", default=d.init_npz,
                    help="warm-start from an exported gaussians npz; "
                         "overrides random init")
    ap.add_argument("--means_lr_final", type=float, default=d.means_lr_final,
                    help="final positional-lr multiplier, decayed "
                         "exponentially over --iters (3DGS uses ~0.01); "
                         "1.0 = constant lr (reference behavior)")
    ap.add_argument("--log_every", type=int, default=d.log_every)
    ap.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--sorted_pair_k", type=int, default=d.sorted_pair_k,
                    help="sorted-mode per-gaussian tile budget "
                         "(0 = measured auto)")
    ap.add_argument("--num_view_shards", type=int, default=d.num_view_shards,
                    help="shard the view batch over N ranks (data "
                         "parallel): launch N processes with `python -m "
                         "torch.distributed.run --standalone "
                         "--nproc_per_node N -m tpu_gaussians_torch.cli.fit "
                         "... --num_view_shards N`")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def params_digest(raw) -> str:
    """sha256 of the parameters' bytes: equal on every rank of a sharded
    fit."""
    h = hashlib.sha256()
    for name, t in sorted(vars(raw).items()):
        if t is not None:
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> None:
    args = vars(build_parser().parse_args(argv))
    initialize_distributed(device=args["device"])
    device = resolve_device(args.pop("device"))
    config = FitConfig(**args)
    rank, world = rank_and_world()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if rank == 0:
        print(f"Using device: {name} (torch {torch.__version__})")

    targets, masks, depths, cameras = load_dataset(config, device=device)
    out_dir = Path(config.out_dir)
    result = fit(config, targets, cameras, masks=masks, depths=depths,
                 out_dir=out_dir, device=device)
    write_artifacts(out_dir, result, config)
    if rank == 0:
        print(f"Done in {result.wall_time_s:.1f}s. Outputs written to: "
              f"{out_dir}")
    if world > 1:
        # One line a rank, written at once: the replicas' parameters, the
        # kernels this rank launched and its share of the all-reduce.
        steps = max(len(result.loss_log), 1)
        line = f"rank {rank} of {world}: " + json.dumps({
            "params_sha256": params_digest(result.raw),
            "kernel_launches": launch_counts(),
            "steps": len(result.loss_log),
            "allreduce_calls_per_step": sharded.allreduce["calls"] / steps,
            "allreduce_bytes_per_step": sharded.allreduce["bytes"] / steps,
            "allreduce_host_ms_per_step": sharded.allreduce["ms"] / steps,
            "wrote_out_dir": rank == 0})
        sys.stdout.flush()
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()

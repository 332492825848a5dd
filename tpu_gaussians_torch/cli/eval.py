"""Evaluation CLI: render a fitted model against target views and report
PSNR / SSIM / L1 per view (the CLI of `tpu_gaussians.cli.eval`: the same
flags, report and printout, with `--impl auto|torch|tiled` and `--device`
added as in the other CLIs).

Usage:
  python -m tpu_gaussians_torch.cli.eval fitted.npz --targets_dir views/ \
      [--camera_npz cams.npz] [--width 128 --height 128] [--out eval.json] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import torch

from tpu_gaussians_torch.core import camera as cam
from tpu_gaussians_torch.core.types import (
    Camera, Gaussians, RenderConfig, resolve_device, resolve_footprint,
    to_device)
from tpu_gaussians_torch.fit.loss import ssim as ssim_fn
from tpu_gaussians_torch.io import image as im
from tpu_gaussians_torch.io.npz import load_gaussians_npz
from tpu_gaussians_torch.io.ply import load_gaussians_ply
from tpu_gaussians_torch.ops.dispatch import render


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", help="Fitted gaussians npz (or .ply)")
    ap.add_argument("--targets_dir", required=True,
                    help="Directory of ground-truth views (PNG/JPG)")
    ap.add_argument("--camera_npz", default="",
                    help="Cameras (view/proj); else the orbit rig")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--fovy", type=float, default=60.0)
    ap.add_argument("--mode", choices=["accum", "sorted"], default="accum")
    ap.add_argument("--footprint", choices=["auto", "axis", "ewa"],
                    default="auto",
                    help="auto: ewa when the model carries quaternions "
                         "(an EWA-trained model evaluated under the axis "
                         "footprint silently drops its rotations)")
    ap.add_argument("--impl", choices=["auto", "torch", "tiled"],
                    default="auto")
    ap.add_argument("--out", default="",
                    help="Optional JSON report path")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def view_metrics(g: Gaussians, cameras: Camera, targets: torch.Tensor,
                 config: RenderConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L1, PSNR, SSIM) per view of `g` rendered from each of the batched
    `cameras` against targets (V,H,W,3)."""
    with torch.no_grad():
        pred = render(g, cameras, config)
        if pred.ndim == 3:
            pred = pred[None]
        l1 = (pred - targets).abs().mean(dim=(1, 2, 3))
        mse = ((pred - targets) ** 2).mean(dim=(1, 2, 3))
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
        return l1, psnr, ssim_fn(pred, targets)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    load = load_gaussians_ply if args.npz.endswith(".ply") \
        else load_gaussians_npz
    g = load(args.npz, device=device)

    paths = im.list_target_paths(args.targets_dir)
    targets = im.load_targets(paths, args.width, args.height)
    v = targets.shape[0]
    if args.camera_npz:
        cameras = cam.load_cameras_npz(args.camera_npz, device=device)
        if cameras.view.shape[0] != v:
            raise ValueError(
                f"camera count {cameras.view.shape[0]} != targets {v}")
    else:
        cameras = cam.orbit_cameras(v, args.width, args.height,
                                    fovy_deg=args.fovy, device=device)

    fp = resolve_footprint(args.footprint, g)
    config = RenderConfig(width=args.width, height=args.height,
                          mode=args.mode, impl=args.impl, footprint=fp)
    l1, psnr, ssim = (t.cpu().numpy() for t in view_metrics(
        g, cameras, to_device(targets, device), config))

    report = {
        "views": [
            {"index": i, "target": str(paths[i]), "psnr": float(psnr[i]),
             "ssim": float(ssim[i]), "l1": float(l1[i])}
            for i in range(v)
        ],
        "mean": {"psnr": float(psnr.mean()), "ssim": float(ssim.mean()),
                 "l1": float(l1.mean())},
        "num_gaussians": int(g.means.shape[0]),
        "mode": args.mode,
        "footprint": fp,
        "size": [args.width, args.height],
    }
    for row in report["views"]:
        print(f"view {row['index']:3d}  PSNR {row['psnr']:6.2f} dB  "
              f"SSIM {row['ssim']:.4f}  L1 {row['l1']:.5f}")
    print(f"mean      PSNR {report['mean']['psnr']:6.2f} dB  "
          f"SSIM {report['mean']['ssim']:.4f}  L1 {report['mean']['l1']:.5f}")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

"""Offline renderer CLI: load a fitted npz and render views to PNG, the
counterpart of `tpu_gaussians.cli.render` (depth-sorted mode).

Usage:
  python -m tpu_gaussians_torch.cli.render fitted.npz --out_dir renders \
      --width 960 --height 540 --mode sorted --num_views 8 [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from tpu_gaussians_torch.core import camera as cam
from tpu_gaussians_torch.core.types import RenderConfig, resolve_device
from tpu_gaussians_torch.io.image import save_image_png
from tpu_gaussians_torch.io.npz import load_gaussians_npz
from tpu_gaussians_torch.ops.dispatch import render


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", help="Fitted gaussians npz (reference schema)")
    ap.add_argument("--out_dir", default="outputs/renders")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--fovy", type=float, default=60.0)
    ap.add_argument("--num_views", type=int, default=1)
    ap.add_argument("--camera_npz", default="",
                    help="Optional view/proj cameras; else orbit rig")
    ap.add_argument("--mode", choices=["accum", "sorted"], default="sorted",
                    help="sorted = depth-aware front-to-back "
                         "(viewer default, model_viewer_main.cpp:199); "
                         "accum comes with the training slice")
    ap.add_argument("--impl", choices=["auto", "torch", "tiled"],
                    default="auto")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--background", type=float, nargs=3,
                    default=[0.02, 0.02, 0.02])
    ap.add_argument("--shard_bands", type=int, default=0,
                    help="Shard each frame's rows over this many devices "
                         "(0 = single-device render; sharding comes with "
                         "the parallel slice)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mode == "accum":
        raise NotImplementedError(
            "--mode accum is ported in slice 2 (accumulation training); "
            "use --mode sorted")
    if args.shard_bands > 0:
        raise NotImplementedError(
            "--shard_bands comes with the parallel slice; use 0")

    device = resolve_device(args.device)
    g = load_gaussians_npz(args.npz, device=device)
    print(f"Loaded {g.capacity} gaussians from {args.npz}")
    if args.camera_npz:
        cameras = cam.load_cameras_npz(args.camera_npz, device=device)
    else:
        cameras = cam.orbit_cameras(args.num_views, args.width, args.height,
                                    fovy_deg=args.fovy, device=device)
    config = RenderConfig(
        width=args.width, height=args.height, mode=args.mode, impl=args.impl,
        background=tuple(args.background))
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        images = render(g, cameras, config)
    if images.ndim == 3:
        images = images[None]
    for i, image in enumerate(images.cpu().numpy()):
        path = out_dir / f"view_{i:03d}.png"
        save_image_png(path, image)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()

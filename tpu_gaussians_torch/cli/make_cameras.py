"""Generate a camera npz (view/proj (V,4,4)) for an orbit rig, for the
--camera_npz flow (the CLI of `tpu_gaussians.cli.make_cameras`). Runs on
the host: no device is needed.

Usage:
  python -m tpu_gaussians_torch.cli.make_cameras cams.npz --num_views 8 \
      --width 256 --height 256 --radius 2.5 --pitch 0.2
"""

from __future__ import annotations

import argparse

from tpu_gaussians_torch.core import camera as cam


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out", help="Output npz path")
    ap.add_argument("--num_views", type=int, default=4)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--radius", type=float, default=2.5)
    ap.add_argument("--pitch", type=float, default=0.2)
    ap.add_argument("--fovy", type=float, default=60.0)
    ap.add_argument("--znear", type=float, default=0.01)
    ap.add_argument("--zfar", type=float, default=100.0)
    args = ap.parse_args(argv)

    cameras = cam.orbit_cameras(
        args.num_views, args.width, args.height,
        radius=args.radius, pitch=args.pitch, fovy_deg=args.fovy,
        znear=args.znear, zfar=args.zfar, device="cpu")
    cam.save_cameras_npz(args.out, cameras)
    print(f"wrote {args.num_views} cameras to {args.out}")


if __name__ == "__main__":
    main()

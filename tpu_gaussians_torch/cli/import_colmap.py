"""Import a COLMAP sparse reconstruction for fitting (the CLI of
`tpu_gaussians.cli.import_colmap`, same flags and outputs).

Converts a COLMAP model dir (usually <scene>/sparse/0, binary or text)
into this package's inputs:

  cameras.npz        view/proj (V,4,4) in the --camera_npz schema,
                     views ordered by image NAME (matching the fit CLI's
                     sorted target glob: point --targets_dir at the
                     dataset's images/ directory)
  image_order.txt    the image names in that order
  init_points.npz    (optional, --init_out) reference-schema gaussians
                     initialized from the SfM point cloud (means = points,
                     colors from point RGB, scales from NN distance, SH
                     degree 1, capacity min(--max_points, P)); feed it to
                     the fit CLI via --init_npz. --seed seeds the
                     torch.Generator of its subsample and anchor draws.

Runs on the host: no device is needed.

Usage:
  python -m tpu_gaussians_torch.cli.import_colmap --colmap_dir scene/sparse/0 \\
      --out_dir outputs/scene [--init_out] [--max_points 100000]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tpu_gaussians_torch.io.colmap import colmap_to_view_proj, read_model
from tpu_gaussians_torch.io.npz import save_raw_npz
from tpu_gaussians_torch.models.gaussian_model import init_params_from_points


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--colmap_dir", required=True,
                    help="COLMAP sparse model dir (e.g. scene/sparse/0)")
    ap.add_argument("--out_dir", default="outputs/colmap_import")
    ap.add_argument("--init_out", action="store_true",
                    help="also write init_points.npz from points3D")
    ap.add_argument("--max_points", type=int, default=100_000)
    ap.add_argument("--znear", type=float, default=0.01)
    ap.add_argument("--zfar", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cams, images, pts, rgb = read_model(args.colmap_dir)
    view, proj, (w, h) = colmap_to_view_proj(cams, images,
                                             args.znear, args.zfar)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "cameras.npz", view=view, proj=proj)
    (out / "image_order.txt").write_text(
        "\n".join(im.name for im in images), encoding="utf-8")
    print(f"wrote {out / 'cameras.npz'}: {len(images)} views, "
          f"native {w}x{h} (aspect {w / h:.3f}); image order in "
          f"image_order.txt")

    if args.init_out:
        if pts.shape[0] == 0:
            raise SystemExit("no points3D in the model; cannot --init_out")
        n = min(args.max_points, pts.shape[0])
        raw = init_params_from_points(
            torch.Generator().manual_seed(args.seed), pts, rgb, capacity=n,
            use_sh=True, sh_degree=1, device="cpu")
        save_raw_npz(out / "init_points.npz", raw)
        print(f"wrote {out / 'init_points.npz'}: {n} gaussians from "
              f"{pts.shape[0]} SfM points")

    print("fit with:\n  python -m tpu_gaussians_torch.cli.fit "
          f"--targets_dir <images_dir> --camera_npz {out / 'cameras.npz'}"
          + (f" --init_npz {out / 'init_points.npz'} --use_sh"
             if args.init_out else ""))


if __name__ == "__main__":
    main()

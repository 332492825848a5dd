"""Convert fitted models between the reference npz schema and the
ecosystem-standard 3DGS PLY format, by file extension (the CLI of
`tpu_gaussians.cli.convert`). Runs on the host: no device is needed.

Usage:
  python -m tpu_gaussians_torch.cli.convert model.npz model.ply
  python -m tpu_gaussians_torch.cli.convert model.ply model.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

from tpu_gaussians_torch.io.npz import load_gaussians_npz, save_gaussians_npz
from tpu_gaussians_torch.io.ply import load_gaussians_ply, save_gaussians_ply


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)

    src, dst = Path(args.src), Path(args.dst)
    g = (load_gaussians_ply(src, device="cpu") if src.suffix == ".ply"
         else load_gaussians_npz(src, device="cpu"))
    if dst.suffix == ".ply":
        save_gaussians_ply(dst, g)
    else:
        save_gaussians_npz(dst, g)
    print(f"converted {g.means.shape[0]} gaussians: {src} -> {dst}")


if __name__ == "__main__":
    main()

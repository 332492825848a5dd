"""Point-cloud viewer CLI: matplotlib 3D scatter of a fitted npz (the CLI
of `tpu_gaussians.cli.view`, parity with the reference's
view_gaussians.py:10-89): subsample to --max_points, alpha from opacity *
alpha_scale clipped to [0.05, 1], marker size proportional to mean |scale|
normalized by the 95th percentile, equal-axis framing, --save PNG at dpi
180 (Agg backend) or an interactive window. matplotlib is imported only
here, inside main: the package imports without it. Runs on the host: no
device is needed.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpu_gaussians_torch.io.npz import load_gaussians_npz


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", help="Fitted gaussians npz")
    ap.add_argument("--max_points", type=int, default=50000)
    ap.add_argument("--alpha_scale", type=float, default=1.0)
    ap.add_argument("--point_scale", type=float, default=1.0)
    ap.add_argument("--save", default="", help="Save PNG instead of showing")
    return ap


def _equal_axes(ax, pts: np.ndarray) -> None:
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    center = (lo + hi) / 2.0
    radius = float((hi - lo).max()) / 2.0 or 1.0
    ax.set_xlim(center[0] - radius, center[0] + radius)
    ax.set_ylim(center[1] - radius, center[1] + radius)
    ax.set_zlim(center[2] - radius, center[2] + radius)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import matplotlib
    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = load_gaussians_npz(args.npz, device="cpu")
    means, scales, opacities = (t.numpy() for t in (g.means, g.scales,
                                                    g.opacities))
    # The npz's colors: the RGB, or an SH model's clamped dc term (the
    # loaded SH model keeps only its coefficients).
    colors = np.asarray(np.load(args.npz)["colors"], np.float32)

    n = means.shape[0]
    if n > args.max_points:
        idx = np.linspace(0, n - 1, args.max_points).astype(np.int64)
        means, scales, colors, opacities = (
            a[idx] for a in (means, scales, colors, opacities))

    alpha = np.clip(opacities * args.alpha_scale, 0.05, 1.0)
    rgba = np.concatenate([np.clip(colors, 0, 1), alpha[:, None]], axis=1)

    mean_scale = np.abs(scales).mean(axis=1)
    p95 = np.percentile(mean_scale, 95) or 1.0
    sizes = 40.0 * args.point_scale * np.clip(mean_scale / p95, 0.05, 2.0)

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(means[:, 0], means[:, 1], means[:, 2], c=rgba, s=sizes,
               linewidths=0)
    _equal_axes(ax, means)
    ax.set_title(f"{means.shape[0]} gaussians")

    if args.save:
        fig.savefig(args.save, dpi=180, bbox_inches="tight")
        print(f"wrote {args.save}")
    else:
        plt.show()


if __name__ == "__main__":
    main()

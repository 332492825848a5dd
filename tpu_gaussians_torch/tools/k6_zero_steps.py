#!/usr/bin/env python3
"""Count the warp steps of K6 (csrc/splat_v2_bwd.cu) whose exps are all
exactly zero: the work that exact culling could skip.

  python3 tpu_gaussians_torch/tools/k6_zero_steps.py [--seed 0]

K6 walks, for each band, its gaussian range 32 gaussians (a warp) at a time
and the band's 2048 pixels 8 at a time; ex2.approx.ftz gives exactly 0
where log2(e) times the exponent is below -126. On the CPU, for the
flagship EWA accum fit's view 0 at its initial parameters (128x128) and
8,192 EWA gaussians on 512x512 (chip_smoke's kernel case), staged by
ops/splat's own y-sort and band staging, prints one JSON line per case
with the warp steps in all and those whose 32 x 8 exponents are all below
-126 (the exponent in f64, so a step at the edge may count either way).
Needs no card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def zero_steps(st, width: int) -> dict:
    """{steps, zero_steps} of K6's walk over the band staging `st` for a
    frame `width` pixels wide (a multiple of 8: steps never straddle a
    row)."""
    import torch

    g = st.gdata.double()
    steps = zero = 0
    for band, (l, c) in enumerate(zip(st.lo.tolist(), st.cnt.tolist())):
        rows = g[l * st.nb:(l + c) * st.nb]
        idx = band * 2048 + torch.arange(2048)
        x = (idx % width).double() + 0.5
        y = (idx // width).double() + 0.5
        for w0 in range(0, rows.shape[0], 32):
            r = rows[w0:w0 + 32]
            dx, dy = x[None] - r[:, 0:1], y[None] - r[:, 1:2]
            e2 = (dx * (r[:, 2:3] * dx + r[:, 3:4] * dy)
                  + r[:, 4:5] * dy * dy) / torch.log(torch.tensor(2.0))
            live = (e2 >= -126).reshape(r.shape[0], -1, 8).any(2).any(0)
            steps += live.numel()
            zero += int((~live).sum())
    return {"steps": steps, "zero_steps": zero,
            "zero_share": zero / max(steps, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, init_params)
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.utils.config import FitConfig

    cfg = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                    camera_npz=str(ROOT / "assets" / "example_scene"
                                   / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, cams = load_dataset(cfg, device="cpu")
    raw = init_params(torch.Generator().manual_seed(args.seed), 800, 3000,
                      use_sh=True, use_quats=True, device="cpu")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n = 8192
    g8192 = make_gaussians(**cs.scene_arrays(n, args.seed + 3),
                           quats=np.random.default_rng(args.seed + 3).normal(
                               size=(n, 4)).astype(np.float32), device="cpu")
    cams_s = cam.orbit_cameras(4, 512, 512, device="cpu")
    for case, g, view, proj, side in (
            ("flagship_ewa_accum_128x128_init", activate(raw), cams.view[0],
             cams.proj[0], cfg.width),
            ("8192_ewa_512x512", g8192, cams_s.view[0], cams_s.proj[0],
             512)):
        with torch.no_grad():
            s = splat.y_sorted(prepare_splats(g, view, proj, side, side,
                                              footprint="ewa"))
            st = splat._v2_prep(s, side, side)
        print(json.dumps({"case": case, "n_pad": st.gdata.shape[0],
                          **zero_steps(st, side)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

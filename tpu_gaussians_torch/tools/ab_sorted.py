#!/usr/bin/env python3
"""Time the sorted-training path of two checkouts on one card, in turns.

  python3 tpu_gaussians_torch/tools/ab_sorted.py OLD_ROOT NEW_ROOT [--rounds 1]

Each round runs OLD, NEW, NEW, OLD, each in a fresh process that imports
`tpu_gaussians_torch` from its checkout (and builds that checkout's
kernels) but drives it with this checkout's `chip_smoke.py` helpers, so
both are measured the same way: chip_smoke's phase 9 main path (cli.fit
with the flagship recipe plus --max_gaussians 4096 --footprint ewa, with
its checks and exact launch counts; steps/s from its "Done in" line) and
20 train steps of the fitted model, then phase 10's 100,000-gaussian EWA
sorted scene at 512x512 (10 train steps; CUDA-event medians, and a
torch.profiler breakdown of 3). Prints one JSON line per process, then one
with the medians per checkout and the card's name and power limit.
Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def one(root: Path, seed: int) -> dict:
    """The sorted phases on the package of checkout `root`."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HARNESS)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    import tpu_gaussians_torch
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import (
        RenderConfig, make_gaussians, resolve_device, to_device)
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.io.npz import load_gaussians_npz
    from tpu_gaussians_torch.kernels import build
    from tpu_gaussians_torch.models.gaussian_model import raw_from_gaussians
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.utils.config import FitConfig

    cs.check(Path(tpu_gaussians_torch.__file__).resolve().parents[1]
             == root.resolve(), f"imported the package from outside {root}")
    resolve_device("cuda")
    build.build_all(["sorted_fwd", "sorted_bwd", "splat_v2_fwd"])
    tmp = tempfile.TemporaryDirectory()
    fit = cs.fit_phase(Path(tmp.name), "fit_sorted", cs.SORTED_FIT_ARGS,
                       {"sorted_fwd": 900, "sorted_bwd": 900,
                        "splat_v2_fwd": 1},
                       expect_line="sorted pair budget k=")
    assets = cs.ROOT / "assets" / "example_scene"
    with contextlib.redirect_stdout(io.StringIO()):
        targets, masks, _, cams = load_dataset(
            FitConfig(targets_dir=str(assets),
                      camera_npz=str(assets / "cameras.npz")), device="cuda")
    targets, masks = to_device(targets, "cuda"), to_device(masks, "cuda")
    raw_fs = raw_from_gaussians(load_gaussians_npz(
        Path(tmp.name) / "fit_sorted" / "gaussians_fitted.npz",
        device="cuda"), capacity=4096)
    flag, _ = cs.train_steps(raw_fs, cams, targets, masks, steps=20,
                             profile=10, render_config=RenderConfig(
                                 mode="sorted", footprint="ewa",
                                 sorted_pair_k=fit["pair_k"]))
    # phase 10's scene: phase 8's generator and targets, seeded quaternions
    n_s, side = 100_000, 512
    arr = cs.scene_arrays(n_s, seed + 2)
    arr["quats"] = np.random.default_rng(seed + 2).normal(
        size=(n_s, 4)).astype(np.float32)
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    targets_s = to_device(np.random.default_rng(seed).uniform(
        0, 1, (4, side, side, 3)), "cuda")
    masks_s = (targets_s.mean(dim=3) > 0.06).to(torch.float32)
    g_e = make_gaussians(**arr, device="cuda")
    pair_k = tiled.auto_pair_k(g_e, cams_s.view, cams_s.proj, side, side,
                               footprint="ewa")
    scale, _ = cs.train_steps(
        raw_from_gaussians(g_e, capacity=n_s), cams_s, targets_s, masks_s,
        steps=10, profile=3, render_config=RenderConfig(
            mode="sorted", footprint="ewa", sorted_pair_k=pair_k))
    tmp.cleanup()
    return {"root": str(root), "fit_steps_per_s": fit["steps_per_s"],
            "flagship_step_ms": flag["step_ms_median"],
            "flagship_busy_ms": flag["profile"]["device_busy_ms_per_call"],
            "scale_step_ms": scale["step_ms_median"],
            "scale_busy_ms": scale["profile"]["device_busy_ms_per_call"],
            "scale_host_ops": scale["profile"]["host_ops_per_call"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        with contextlib.redirect_stdout(sys.stderr):
            out = one(args.one, args.seed)
        print(json.dumps(out), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts: OLD_ROOT NEW_ROOT")
    old, new = args.roots
    runs = {str(old): [], str(new): []}
    for _ in range(args.rounds):
        for root in (old, new, new, old):
            proc = subprocess.run(
                [sys.executable, __file__, "--one", str(root), "--seed",
                 str(args.seed)], capture_output=True, text=True,
                timeout=1200)
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                raise RuntimeError(f"ab_sorted: {root} failed "
                                   f"(rc {proc.returncode})")
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[str(root)].append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi, "medians": {
        root: {k: statistics.median(r[k] for r in rs)
               for k in rs[0] if k != "root"}
        for root, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

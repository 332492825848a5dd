#!/usr/bin/env python3
"""Price K4's per-pass cluster barrier on one card.

  python3 tpu_gaussians_torch/tools/k4_barrier.py [--seed 0] [--rounds 5]

Builds a copy of `csrc/sorted_bwd.cu` with the cluster barrier that ends
each pass of staged slots taken out (the barrier before exit stays, so no
block leaves early; the copy's rows are wrong, since blocks then read their
neighbours' partial rows unsynchronised, and only its time is used), and
times it in turns with K4 (CUDA-event medians of 20 launches, `--rounds`
rounds, the median of the rounds) on chip_smoke's phase-10 inputs: the
binner's lists of view 0 of the 100,000-gaussian EWA scene at 512x512 with
its measured pair budget, K3's acc and chunks_done and a seeded N(0,1)
cotangent, for both footprints. Prints one JSON line per footprint and the
card's name and power limit. Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NEEDLE = "    cluster.sync();\n\n    // Slots rank*SR"


def without_pass_barrier(build):
    """sorted_bwd_launch of the barrier-free copy, built now."""
    src = (build.CSRC / "sorted_bwd.cu").read_text()
    if src.count(NEEDLE) != 1:
        raise RuntimeError("sorted_bwd.cu's per-pass barrier not found")
    build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD / "sorted_bwd_no_pass_barrier.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src.replace(NEEDLE, "\n    // Slots rank*SR"))
    subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(so), str(cu)],
                   capture_output=True, text=True, timeout=600, check=True)
    fn = ctypes.CDLL(str(so)).sorted_bwd_launch
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians, resolve_device
    from tpu_gaussians_torch.kernels import build, sorted_bwd, sorted_fwd
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.binning import EXIT_T
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    resolve_device("cuda")
    build.build_all(["sorted_fwd", "sorted_bwd"])
    no_barrier = without_pass_barrier(build)

    n, side = 100_000, 512
    arr = cs.scene_arrays(n, args.seed + 2)
    arr["quats"] = np.random.default_rng(args.seed + 2).normal(
        size=(n, 4)).astype(np.float32)
    g = make_gaussians(**arr, device="cuda")
    cams = cam.orbit_cameras(4, side, side, device="cuda")
    pair_k = tiled.auto_pair_k(g, cams.view, cams.proj, side, side,
                               footprint="ewa")
    for footprint in ("ewa", "axis"):
        axis = footprint == "axis"
        with torch.no_grad():
            s = prepare_splats(g, cams.view[0], cams.proj[0], side, side,
                               footprint=footprint)
            gdense, cnt, tiles_x, _, _ = tiled.tile_lists(
                s, camera_z(g.means, cams.view[0]), side, side, 0, pair_k)
            acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, tiles_x,
                                                  axis=axis, exit_t=EXIT_T)
            g8 = torch.randn(acc.shape, generator=torch.Generator(
                device="cuda").manual_seed(args.seed), device="cuda")
            n_tiles = cnt.shape[0]
            out = torch.empty_like(gdense)
            ptrs = [ctypes.c_void_p(t.data_ptr())
                    for t in (gdense, cnt, acc, g8, chunks, out)] + [
                ctypes.c_void_p(None)]        # no walk counter

            def k4():
                sorted_bwd.sorted_bwd(gdense, cnt, acc, g8, chunks, tiles_x,
                                      axis)

            def k4_no_barrier():
                err = no_barrier(*ptrs, ctypes.c_int(tiles_x),
                                 ctypes.c_int(n_tiles),
                                 ctypes.c_int(gdense.shape[0] // n_tiles),
                                 ctypes.c_int(int(axis)), ctypes.c_void_p(
                                     torch.cuda.current_stream().cuda_stream))
                cs.check(err == 0, f"barrier-free K4: CUDA error {err}")

            k_ms, nb_ms = [], []
            for _ in range(args.rounds):
                k_ms.append(cs.time_ms(k4, 20))
                nb_ms.append(cs.time_ms(k4_no_barrier, 20))
        k, nb = statistics.median(k_ms), statistics.median(nb_ms)
        print(json.dumps({"footprint": footprint, "tiles": n_tiles,
                          "pair_k": pair_k, "k4_ms": k,
                          "without_pass_barrier_ms": nb,
                          "pass_barrier_ms": k - nb,
                          "k4_rounds_ms": k_ms,
                          "without_pass_barrier_rounds_ms": nb_ms}),
              flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build and time K8a alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k8a.py [OTHER.cu ...] [--rounds 3]
      [--seed 0]

Builds this tree's `csrc/binned_fwd.cu` and each OTHER source (for example
the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/binned_fwd.cu
> _scratch/parent.cu`), each under its own library name in `_build/`, all
nvcc processes started together; prints ptxas' register lines and the HMMA
count of each build's kernel. A build whose library exports
`binned_fwd_slice_len` is launched with its slice scratch, one without it
(the parent's) without. Then builds two of chip_smoke's K8a inputs through
`ops/binned.accum_lists`: the flagship EWA binned fit's (the example
scene's view 0 at 128x128; 800 gaussians at capacity 16384 from the fit's
own initialisation with --use_sh --footprint ewa and seed --seed, not the
fitted model: 8 tiles of cap 8192) and 100k_512x512_ewa (phase 10's scene
at its initial parameters, view 0: 128 tiles of cap 8192, some full). On
each, every build is held against the plain twin (rtol/atol 1e-5), against
this tree's build (largest difference) and against itself across two
launches (bit for bit); then all are timed in turns (CUDA-event medians of
20 launches, `--rounds` rounds, the median of the rounds, as chip_smoke
times a kernel: the wrapper's host work is inside it), and each build's
device time per call is read from torch.profiler over 20 calls, its main
kernel and its slice sum apart. Prints one JSON line per case, with K8a's
bound on this card (chip_smoke's `binned_fwd_bound`, the SM clock read
while this tree's build runs) and the card's name and power limit. This
tree's build failing a check fails the run; another build's failure is
reported and it is timed all the same. Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import sys
from pathlib import Path

import ab_builds

ROOT = ab_builds.ROOT
KERNEL = "binned_fwd"


def launcher(cs, so: Path, kernel: str = KERNEL):
    """K8a (or K7a: kernel "binned_sep_fwd") -> acc (8, n_tiles*2048)
    through the launcher of library `so`, with the slice scratch if the
    library takes one."""
    import torch

    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"{kernel}_launch")
    fn.restype = ctypes.c_int
    slice_len = getattr(lib, f"{kernel}_slice_len", None)
    sliced = slice_len is not None

    def run(gdense, cnt, tiles_x):
        n_tiles = cnt.shape[0]
        cap = gdense.shape[0] // n_tiles
        out = torch.empty((8, n_tiles * 2048), device="cuda")
        tensors = [gdense, cnt]
        if sliced:
            length = slice_len(n_tiles, cap)
            slices = -(-cap // length)
            tensors.append(out if slices == 1 else torch.empty(
                (slices, *out.shape), device="cuda"))
        tensors.append(out)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors),
                 *(ctypes.c_int(v) for v in (tiles_x, n_tiles, cap)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    return run


def lists_cases(cs, seed: int, footprint: str = "ewa"):
    """[(case, (gdense, cnt, tiles_x))] for the flagship EWA binned fit's
    view 0 at its initial parameters and 100k_512x512_ewa's view 0; for
    footprint "axis", the flagship axis binned fit's (800 gaussians at
    capacity 3000, no quaternions) and 100k_512x512_axis's (the same scene
    without its quaternions)."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, init_params)
    from tpu_gaussians_torch.ops.binned import accum_lists
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.utils.config import FitConfig

    axis = footprint == "axis"

    def lists(g, view, proj, width, height):
        with torch.no_grad():
            s = prepare_splats(g, view, proj, width, height,
                               footprint=footprint)
            gdense, cnt, tiles_x, _, _ = accum_lists(s, height, width)
        return gdense, cnt, tiles_x

    cfg = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                    camera_npz=str(ROOT / "assets" / "example_scene"
                                   / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, cams = load_dataset(cfg, device="cuda")
    raw = init_params(torch.Generator().manual_seed(seed), 800,
                      3000 if axis else 16384, use_sh=True,
                      use_quats=not axis, device="cuda")
    side, n = 512, 100_000
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    arr = cs.scene_arrays(n, seed + 2)
    if not axis:
        arr["quats"] = np.random.default_rng(seed + 2).normal(
            size=(n, 4)).astype(np.float32)
    g_s = make_gaussians(**arr, device="cuda")
    kind = "axis" if axis else "ewa"
    return [(f"flagship_{kind}_binned_128x128_init",
             lists(activate(raw), cams.view[0], cams.proj[0], cfg.width,
                   cfg.height)),
            (f"100k_512x512_{kind}_init",
             lists(g_s, cams_s.view[0], cams_s.proj[0], side, side))]


def main() -> int:
    args, cs = ab_builds.setup(__doc__)

    import torch

    from tpu_gaussians_torch.kernels import binned

    runs, hmma = ab_builds.load_builds(KERNEL, args.others,
                                       lambda so: launcher(cs, so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, kargs in lists_cases(cs, args.seed):
        gdense, cnt, tiles_x = kargs
        n_tiles = cnt.shape[0]
        cap = gdense.shape[0] // n_tiles
        kernels, info = ab_builds.compare(
            cs, f"K8a {case}", runs, hmma, kargs, binned.binned_fwd_plain,
            args.rounds, feature_dim=0,
            split=("binned_fwd_kernel", "slice_sum_kernel"))
        bound = cs.binned_fwd_bound(cnt, cap, sms, info.pop("sm_clock_mhz"))
        for k in kernels.values():
            k["device_ms_slice_sum"] = k.pop("device_ms_second")
            k["share_of_bound"] = bound["fwd_bound_ms"] / k["device_ms"]
        print(json.dumps({
            "case": case, "tiles": n_tiles, "tiles_x": tiles_x, "cap": cap,
            "slots_live": int(cnt.to(torch.int64).sum()),
            "max_cnt": int(cnt.max()), "full_tiles": int((cnt >= cap).sum()),
            **info, **bound, "kernels": kernels}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build and time K1 alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k1.py [OTHER.cu ...] [--rounds 3]
      [--seed 0]

Builds this tree's `csrc/splat_sep_fwd.cu` and each OTHER source (for
example the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/
splat_sep_fwd.cu > _scratch/parent.cu`), each under its own library name in
`_build/`, all nvcc processes started together; prints ptxas' register
lines and the HMMA count of each build's kernel. A build whose library
exports `splat_sep_fwd_slice_len` is launched with its slice scratch, one
without it (the parent's) without. Then stages two of chip_smoke's K1
cases through `ops/splat.stage`: the flagship fit's (the example scene's
view 0 at 128x128; 800 gaussians at capacity 3000 from the fit's own
initialisation with --use_sh and seed --seed, not the fitted model: R 64,
Wp 128, 2 bands) and 100k_512x512 (phase 8's scene at its initial
parameters, view 0: R 32, Wp 512, 16 bands). On each, every build is held
against the plain twin (rtol/atol 1e-5), against this tree's build
(largest difference) and against itself across two launches (bit for
bit); then all are timed in turns (CUDA-event medians of 20 launches,
`--rounds` rounds, the median of the rounds, as chip_smoke times a kernel:
the wrapper's host work is inside it), and each build's device time per
call is read from torch.profiler over 20 calls (its kernels alone). Prints
one JSON line per case, with K1's bound on this card (chip_smoke's
`sep_fwd_bound`, the SM clock read while this tree's build runs) and the
card's name and power limit. This tree's build failing a check fails the
run; another build's failure is reported and it is timed all the same.
Needs one NVIDIA GPU and nvcc.
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
KERNEL = "splat_sep_fwd"


def launcher(cs, so: Path):
    """K1 -> acc (n_bands, 5, R, Wp) through the launcher of library `so`,
    with the slice scratch if the library takes one."""
    import torch

    lib = ctypes.CDLL(str(so))
    fn = lib.splat_sep_fwd_launch
    fn.restype = ctypes.c_int
    sliced = hasattr(lib, "splat_sep_fwd_slice_len")

    def run(lo, cnt, gdata, rows, wp, nb):
        n_bands, n_pad = lo.shape[0], gdata.shape[0]
        shape = (n_bands, 5, rows, wp)
        out = torch.empty(shape, device="cuda")
        tensors = [lo, cnt, gdata]
        if sliced:
            length = lib.splat_sep_fwd_slice_len(n_bands, rows, wp, n_pad)
            slices = -(-n_pad // length)
            tensors.append(out if slices == 1 else torch.empty(
                (slices, *shape), device="cuda"))
        tensors.append(out)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors),
                 *(ctypes.c_int(v) for v in (n_bands, rows, wp, nb, n_pad)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    return run


def staged_cases(cs, seed: int):
    """[(case, (lo, cnt, gdata, rows, wp, nb))] for the flagship fit's
    view 0 at its initial parameters and 100k_512x512's view 0."""
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, init_params)
    from tpu_gaussians_torch.utils.config import FitConfig

    cfg = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                    camera_npz=str(ROOT / "assets" / "example_scene"
                                   / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, cams = load_dataset(cfg, device="cuda")
    raw = init_params(torch.Generator().manual_seed(seed), 800, 3000,
                      use_sh=True, device="cuda")
    side = 512
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    g_s = make_gaussians(**cs.scene_arrays(100_000, seed + 2),
                         device="cuda")
    return [("flagship_128x128_init",
             cs.staged_sep(activate(raw), cams.view[0], cams.proj[0],
                           cfg.width, cfg.height)),
            ("100k_512x512_init",
             cs.staged_sep(g_s, cams_s.view[0], cams_s.proj[0], side, side))]


def main() -> int:
    args, cs = ab_builds.setup(__doc__)

    import torch

    from tpu_gaussians_torch.kernels import splat_sep

    runs, hmma = ab_builds.load_builds(KERNEL, args.others,
                                       lambda so: launcher(cs, so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, kargs in staged_cases(cs, args.seed):
        lo, cnt, gdata, rows, wp, nb = kargs
        kernels, info = ab_builds.compare(
            cs, f"K1 {case}", runs, hmma, kargs, splat_sep.sep_fwd_plain,
            args.rounds, feature_dim=1)
        bound = cs.sep_fwd_bound(lo, cnt, gdata, rows, wp, nb, sms,
                                 info.pop("sm_clock_mhz"))
        for k in kernels.values():
            k["share_of_bound"] = bound["fwd_bound_ms"] / k["device_ms"]
        print(json.dumps({
            "case": case, "n_pad": gdata.shape[0], "nb": nb, "rows": rows,
            "wp": wp, "n_bands": lo.shape[0],
            "pairs_evaluated": int(cnt.to(torch.int64).sum()) * nb,
            **info, **bound, "kernels": kernels}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

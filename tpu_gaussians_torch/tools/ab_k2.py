#!/usr/bin/env python3
"""Build and time K2 alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k2.py [OTHER.cu ...] [--rounds 3]
      [--seed 0]

Builds this tree's `csrc/splat_sep_bwd.cu` and each OTHER source (for
example the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/
splat_sep_bwd.cu > _scratch/parent.cu`), each under its own library name in
`_build/`, all nvcc processes started together; prints ptxas' register
lines and the HMMA count of each build's kernel. A build whose library
exports `splat_sep_bwd_slices` is launched with its slice scratch, one
without it (the parent's) without. Then stages the two K1 cases of
`tools/ab_k1.py` (the flagship fit's view 0 at its initial parameters: R
64, Wp 128, 2 bands; 100k_512x512's view 0: R 32, Wp 512, 16 bands) and
draws a seeded N(0,1) cotangent gband for each. On each, every build is
held against the plain twin (K2's tolerance: rtol 2e-4 and atol 2e-5 times
the largest magnitude of the output column, at least 1), against this
tree's build (largest difference) and against itself across two launches
(bit for bit); then all are timed in turns (CUDA-event medians of 20
launches, `--rounds` rounds, the median of the rounds, as chip_smoke times
a kernel: the wrapper's host work is inside it), and each build's device
time per call is read from torch.profiler over 20 calls, its main kernel
and its slice sum apart. Prints one JSON line per case, with K2's bound on
this card (chip_smoke's `sep_bwd_bound`, the SM clock read while this
tree's build runs) and the card's name and power limit. This tree's build
failing a check fails the run; another build's failure is reported and it
is timed all the same. Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import ab_builds
import ab_k1

KERNEL = "splat_sep_bwd"


def launcher(cs, so: Path):
    """K2 -> rows (n_pad, 16) through the launcher of library `so`, with
    the slice scratch if the library takes one."""
    import torch

    lib = ctypes.CDLL(str(so))
    fn = lib.splat_sep_bwd_launch
    fn.restype = ctypes.c_int
    sliced = hasattr(lib, "splat_sep_bwd_slices")

    def run(lo, cnt, gdata, gband, rows, wp, nb):
        n_bands, n_pad = lo.shape[0], gdata.shape[0]
        out = torch.empty_like(gdata)
        tensors = [lo, cnt, gdata, gband]
        if sliced:
            slices = lib.splat_sep_bwd_slices(rows, wp, n_pad)
            tensors.append(out if slices == 1 else torch.empty(
                (slices, *gdata.shape), device="cuda"))
        tensors.append(out)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors),
                 *(ctypes.c_int(v) for v in (n_bands, rows, wp, nb, n_pad)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    return run


def moments_close(out, ref) -> bool:
    """K2's tolerance against its twin (chip_smoke's)."""
    import torch

    scale = torch.clamp(ref.abs().amax(dim=0), min=1.0)
    return not bool(((out - ref).abs() > 2e-4 * ref.abs()
                     + 2e-5 * scale).any())


def main() -> int:
    args, cs = ab_builds.setup(__doc__)

    import torch

    from tpu_gaussians_torch.kernels import splat_sep

    runs, hmma = ab_builds.load_builds(KERNEL, args.others,
                                       lambda so: launcher(cs, so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for case, (lo, cnt, gdata, rows, wp, nb) in ab_k1.staged_cases(
            cs, args.seed):
        gband = torch.randn((lo.shape[0], splat_sep.FEAT, rows, wp),
                            generator=gen, device="cuda")
        kargs = (lo, cnt, gdata, gband, rows, wp, nb)
        kernels, info = ab_builds.compare(
            cs, f"K2 {case}", runs, hmma, kargs, splat_sep.sep_bwd_plain,
            args.rounds, feature_dim=1,
            split=("splat_sep_bwd_kernel", "splat_sep_bwd_sum_kernel"),
            close=moments_close)
        bound = cs.sep_bwd_bound(lo, cnt, gdata, rows, wp, nb, sms,
                                 info.pop("sm_clock_mhz"))
        for k in kernels.values():
            k["device_ms_slice_sum"] = k.pop("device_ms_second")
            k["share_of_bound"] = bound["bwd_bound_ms"] / k["device_ms"]
        print(json.dumps({
            "case": case, "n_pad": gdata.shape[0], "nb": nb, "rows": rows,
            "wp": wp, "n_bands": lo.shape[0],
            "pairs_evaluated": int(cnt.to(torch.int64).sum()) * nb,
            **info, **bound, "kernels": kernels}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

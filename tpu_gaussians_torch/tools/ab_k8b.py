#!/usr/bin/env python3
"""Build and time K8b alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k8b.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/binned_bwd.cu` and each OTHER source (for example
the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/binned_bwd.cu
> _scratch/parent.cu`), each under its own library name in `_build/`, all
nvcc processes started together; prints ptxas' register lines and the HMMA
count of each build's kernel. --ablations adds copies of this tree's
kernel with a part of its work taken out or changed: no_exp (exp(e) = e,
no ex2) and one_mma (one product where there are three, its operands kept
live), whose sums are wrong and which are timed only; no_pixel_split (one
pixel slice at every shape), four_slices (four at every shape) and
two_buffers (the tile's cotangent staged through two 512-pixel buffers,
K9b's double buffering, where the kernel keeps the whole tile), which are
held to the twin like any build. Then builds the two K8 inputs of
`tools/ab_k8a.py` (the flagship EWA binned fit's view 0 at its initial
parameters: 8 tiles of cap 8192; 100k_512x512_ewa's view 0: 128 tiles of
cap 8192) and draws a seeded N(0,1) cotangent for each. On each, every
build is held against the plain twin (K8b's tolerance: rtol 2e-4 and atol
2e-5 times the largest magnitude of the output column, at least 1),
against this tree's build (largest difference) and against itself across
two launches (bit for bit); then all are timed in turns (CUDA-event
medians of 20 launches, `--rounds` rounds, the median of the rounds, as
chip_smoke times a kernel: the wrapper's host work is inside it), and each
build's device time per call is read from torch.profiler over 20 calls.
Prints one JSON line per case, with K8b's bound on this card (chip_smoke's
`binned_bwd_bound`, the SM clock read while this tree's build runs) and
the card's name and power limit. This tree's build failing a check fails
the run; another build's failure is reported and it is timed all the same.
Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import ab_builds
import ab_k8a

KERNEL = "binned_bwd"
ABLATIONS = {
    "no_exp": [(
        "ex[i] = ex2(fmaf(dx, fmaf(L.ah[G], dx, L.bdy[G]), L.cdy2[G]));",
        "ex[i] = fmaf(dx, fmaf(L.ah[G], dx, L.bdy[G]), L.cdy2[G]);")],
    "one_mma": [(
        """  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);""",
        """  const uint32_t a[4] = {ab[0] ^ as[0], ab[1] ^ as[1], ab[2] ^ as[2],
                         ab[3] ^ as[3]};
  mma(c, a, bb0 ^ bs0, bb1 ^ bs1);""")],
    "no_pixel_split": [("constexpr int MAX_SLICES = WARPS;",
                        "constexpr int MAX_SLICES = 1;")],
    "four_slices": [("constexpr long TARGET_BLOCKS = 2048;",
                     "constexpr long TARGET_BLOCKS = 1L << 40;")],
    "two_buffers": [("constexpr int NBUF = 4;", "constexpr int NBUF = 2;")],
}
WRONG_SUMS = ("no_exp", "one_mma")


def ablation_sources(build):
    """The --ablations copies of this tree's kernel, written to _build/."""
    src = (build.CSRC / f"{KERNEL}.cu").read_text()
    build.BUILD.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: snippet not found in {KERNEL}.cu")
            text = text.replace(old, new)
        paths.append(build.BUILD / f"{name}.cu")
        paths[-1].write_text(text)
    return paths


def launcher(cs, so: Path, kernel: str = KERNEL):
    """K8b (or K7b: kernel "binned_sep_bwd") -> raw rows (n_tiles*cap, 16)
    through the launcher of library `so` (this tree's and the parent's take
    the same arguments)."""
    import torch

    fn = getattr(ctypes.CDLL(str(so)), f"{kernel}_launch")
    fn.restype = ctypes.c_int

    def run(gdense, cnt, g8, tiles_x):
        n_tiles = cnt.shape[0]
        out = torch.empty_like(gdense)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (gdense, cnt, g8,
                                                            out)),
                 *(ctypes.c_int(v) for v in (tiles_x, n_tiles,
                                             gdense.shape[0] // n_tiles)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    return run


def moments_close(out, ref) -> bool:
    """K8b's tolerance against its twin: rtol 2e-4 and atol 2e-5 times the
    largest magnitude of the output column (at least 1)."""
    import torch

    scale = torch.clamp(ref.abs().amax(dim=0), min=1.0)
    return not bool(((out - ref).abs() > 2e-4 * ref.abs() + 2e-5 * scale)
                    .any())


def main() -> int:
    args, cs = ab_builds.setup(__doc__, ablations=True)

    import torch

    from tpu_gaussians_torch.kernels import binned, build

    others = list(args.others) + (ablation_sources(build)
                                  if args.ablations else [])
    runs, hmma = ab_builds.load_builds(KERNEL, others,
                                       lambda so: launcher(cs, so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, (gdense, cnt, tiles_x) in ab_k8a.lists_cases(cs, args.seed):
        n_tiles = cnt.shape[0]
        cap = gdense.shape[0] // n_tiles
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 8)
        g8 = torch.randn((8, n_tiles * 2048), generator=gen, device="cuda")
        kernels, info = ab_builds.compare(
            cs, f"K8b {case}", runs, hmma, (gdense, cnt, g8, tiles_x),
            binned.binned_bwd_plain, args.rounds, feature_dim=1,
            close=moments_close)
        bound = cs.binned_bwd_bound(cnt, cap, sms, info.pop("sm_clock_mhz"))
        for tag, k in kernels.items():
            k["share_of_bound"] = bound["bwd_bound_ms"] / k["device_ms"]
            k["sums_wrong_by_design"] = tag in WRONG_SUMS
        print(json.dumps({
            "case": case, "tiles": n_tiles, "tiles_x": tiles_x, "cap": cap,
            "slots_live": int(cnt.to(torch.int64).sum()),
            "max_cnt": int(cnt.max()), "full_tiles": int((cnt >= cap).sum()),
            **info, **bound, "kernels": kernels}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build and time K7a alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k7a.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/binned_sep_fwd.cu` and each OTHER source (for
example the parent's copy: `git show
HEAD~1:tpu_gaussians_torch/csrc/binned_sep_fwd.cu > _scratch/parent.cu`),
each under its own library name in `_build/`, all nvcc processes started
together; prints ptxas' register lines and the HMMA count of each build's
kernel. A build whose library exports `binned_sep_fwd_slice_len` is
launched with its slice scratch, one without it (the parent's) without.
--ablations adds copies of this tree's kernel with a part of its work
taken out or changed: one_mma (one TF32 product where there are three,
its operands kept live) and no_exp (the operands' exps taken out: Ex and
Ey are their exponents), whose sums are wrong and which are timed only;
one_slice (each tile's whole list in one block), twice_the_slices (a
target of twice the blocks) and chunk128 (128-slot chunks, half the
barriers), which are held to the twin like any build. Then builds two of
chip_smoke's K7a inputs through `ops/binned.accum_lists`: the flagship
axis binned fit's (the example scene's view 0 at 128x128; 800 gaussians
at capacity 3000 from the fit's own initialisation with --use_sh and seed
--seed, not the fitted model: 8 tiles of cap 3072) and
100k_512x512_axis's (phase 8's scene at its initial parameters, view 0:
128 tiles of cap 8192, some full). On each, every build is held against
the plain twin (rtol/atol 1e-5), against this tree's build (largest
difference) and against itself across two launches (bit for bit); then
all are timed in turns (CUDA-event medians of 20 launches, `--rounds`
rounds, the median of the rounds, as chip_smoke times a kernel: the
wrapper's host work is inside it), and each build's device time per call
is read from torch.profiler over 20 calls, its main kernel and its slice
sum apart. Prints one JSON line per case, with K7a's bound on this card
(chip_smoke's `binned_sep_fwd_bound`, its terms, the SM clock read while
this tree's build runs) and the card's name and power limit. This tree's
build failing a check fails the run; another build's failure is reported
and it is timed all the same. Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import json
import sys

import ab_builds
import ab_k8a

KERNEL = "binned_sep_fwd"
# name: [(snippet of csrc/binned_sep_fwd.cu, replacement, occurrences)]
ABLATIONS = {
    "one_mma": [(
        """  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);""",
        """  const uint32_t a[4] = {ab[0] ^ as[0], ab[1] ^ as[1], ab[2] ^ as[2],
                         ab[3] ^ as[3]};
  mma(c, a, bb0 ^ bs0, bb1 ^ bs1);""", 1)],
    "no_exp": [("= ex2(", "= (", 5)],
    "one_slice": [("constexpr long TARGET_BLOCKS = 2048;",
                   "constexpr long TARGET_BLOCKS = 1;", 1)],
    "twice_the_slices": [("constexpr long TARGET_BLOCKS = 2048;",
                          "constexpr long TARGET_BLOCKS = 4096;", 1)],
    "chunk128": [("constexpr int KC = 64; ", "constexpr int KC = 128;", 1)],
}
WRONG_SUMS = ("one_mma", "no_exp")


def main() -> int:
    args, cs = ab_builds.setup(__doc__, ablations=True)

    import torch

    from tpu_gaussians_torch.kernels import binned, build

    others = list(args.others) + (
        ab_builds.ablation_sources(build, KERNEL, ABLATIONS)
        if args.ablations else [])
    runs, hmma = ab_builds.load_builds(
        KERNEL, others, lambda so: ab_k8a.launcher(cs, so, KERNEL))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, kargs in ab_k8a.lists_cases(cs, args.seed, footprint="axis"):
        gdense, cnt, tiles_x = kargs
        n_tiles = cnt.shape[0]
        cap = gdense.shape[0] // n_tiles
        kernels, info = ab_builds.compare(
            cs, f"K7a {case}", runs, hmma, kargs,
            binned.binned_sep_fwd_plain, args.rounds, feature_dim=0,
            split=("binned_sep_fwd_kernel", "slice_sum_kernel"))
        bound = cs.binned_sep_fwd_bound(cnt, cap, sms,
                                        info.pop("sm_clock_mhz"))
        for tag, k in kernels.items():
            k["device_ms_slice_sum"] = k.pop("device_ms_second")
            k["share_of_bound"] = bound["fwd_bound_ms"] / k["device_ms"]
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

#!/usr/bin/env python3
"""Build and time K7b alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k7b.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/binned_sep_bwd.cu` and each OTHER source (for
example the parent's copy: `git show
HEAD~1:tpu_gaussians_torch/csrc/binned_sep_bwd.cu > _scratch/parent.cu`;
it takes the same launcher arguments), each under its own library name in
`_build/`, all nvcc processes started together; prints ptxas' register
lines, the HMMA count and the SASS opcode counts of each build's
kernel. --ablations adds copies
of this tree's kernel with a part of its work taken out or changed:
one_mma (one TF32 product where there are three, its operands kept live)
and no_exp (the exps taken out: Ex and Ey are their exponents), whose
sums are wrong and which are timed only; one_col_slice (the columns never
split), two_col_slices (every block's columns split in 2, 64 slots a
block, at every shape), one_group (blocks of 128 slots, no walk over
groups), twice_the_blocks (a target of twice the blocks: fewer groups a
block) and split_at_load (the tile's cotangent staged as it is, 68 KB,
and split at every load, in blocks of 4 warps two an SM), which are held
to the twin like any build. Then builds the two K7 inputs of
`tools/ab_k7a.py` (the flagship axis binned fit's view 0 at its initial
parameters: 8 tiles of cap 3072; 100k_512x512_axis's view 0: 128 tiles
of cap 8192) and draws a seeded N(0,1) cotangent for each. On each, every
build is held against the plain twin (K7b's tolerance: rtol 2e-4 and atol
2e-5 times the largest magnitude of the output column, at least 1),
against this tree's build (largest difference) and against itself across
two launches (bit for bit); then all are timed in turns (CUDA-event
medians of 20 launches, `--rounds` rounds, the median of the rounds, as
chip_smoke times a kernel: the wrapper's host work is inside it), and
each build's device time per call is read from torch.profiler over 20
calls. Prints one JSON line per case, with K7b's bound on this card
(chip_smoke's `binned_sep_bwd_bound`, its terms, the SM clock read while
this tree's build runs), its column slices, and the card's name and power
limit. This tree's build failing a check fails the run; another build's
failure is reported and it is timed all the same. Needs one NVIDIA GPU
and nvcc.
"""

from __future__ import annotations

import json
import sys

import ab_builds
import ab_k8a
import ab_k8b

KERNEL = "binned_sep_bwd"
# name: [(snippet of csrc/binned_sep_bwd.cu, replacement, occurrences)]
ABLATIONS = {
    "one_mma": [(
        """  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);""",
        """  const uint32_t a[4] = {ab[0] ^ as[0], ab[1] ^ as[1], ab[2] ^ as[2],
                         ab[3] ^ as[3]};
  mma(c, a, bb0 ^ bs0, bb1 ^ bs1);""", 1)],
    "no_exp": [("= ex2(", "= (", 3)],
    "one_col_slice": [("constexpr int MAX_SLICES = TWC / STRIP;",
                       "constexpr int MAX_SLICES = 1;", 1)],
    "two_col_slices": [("constexpr long TARGET_BLOCKS = 2048;",
                        "constexpr long TARGET_BLOCKS = 1L << 40;", 1)],
    "one_group": [("constexpr int MAX_GROUPS = 4;",
                   "constexpr int MAX_GROUPS = 1;", 1)],
    "twice_the_blocks": [("constexpr long TARGET_BLOCKS = 2048;",
                          "constexpr long TARGET_BLOCKS = 4096;", 1)],
    "split_at_load": [
        ("constexpr int THREADS = 256;", "constexpr int THREADS = 128;", 1),
        ("  float band[2 * PLANE];", "  float band[PLANE];", 1),
        ("""    uint4 big, small;
    split(v.x, big.x, small.x);
    split(v.y, big.y, small.y);
    split(v.z, big.z, small.z);
    split(v.w, big.w, small.w);
    *reinterpret_cast<uint4*>(&S.band[row * BS + c]) = big;
    *reinterpret_cast<uint4*>(&S.band[PLANE + row * BS + c]) = small;""",
         """    *reinterpret_cast<float4*>(&S.band[row * BS + c]) = v;""", 1),
        ("""        mma3(acc2[n], ab, as, __float_as_uint(b[0]),
             __float_as_uint(b[4 * BS]), __float_as_uint(b[PLANE]),
             __float_as_uint(b[PLANE + 4 * BS]));""",
         """        uint32_t bb0, bb1, bs0, bs1;
        split(b[0], bb0, bs0);
        split(b[4 * BS], bb1, bs1);
        mma3(acc2[n], ab, as, bb0, bb1, bs0, bs1);""", 1),
        ("""        const uint2 bb = *reinterpret_cast<const uint2*>(b);
        const uint2 bs = *reinterpret_cast<const uint2*>(b + PLANE);
        mma3(acc1[j], ab, as, bb.x, bb.y, bs.x, bs.y);""",
         """        const float2 v = *reinterpret_cast<const float2*>(b);
        uint32_t bb0, bb1, bs0, bs1;
        split(v.x, bb0, bs0);
        split(v.y, bb1, bs1);
        mma3(acc1[j], ab, as, bb0, bb1, bs0, bs1);""", 1),
        ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)", 1)],
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
        KERNEL, others, lambda so: ab_k8b.launcher(cs, so, KERNEL))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, (gdense, cnt, tiles_x) in ab_k8a.lists_cases(
            cs, args.seed, footprint="axis"):
        n_tiles = cnt.shape[0]
        cap = gdense.shape[0] // n_tiles
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 8)
        g8 = torch.randn((8, n_tiles * 2048), generator=gen, device="cuda")
        kernels, info = ab_builds.compare(
            cs, f"K7b {case}", runs, hmma, (gdense, cnt, g8, tiles_x),
            binned.binned_sep_bwd_plain, args.rounds, feature_dim=1,
            close=ab_k8b.moments_close)
        bound = cs.binned_sep_bwd_bound(cnt, cap, sms,
                                        info.pop("sm_clock_mhz"))
        for tag, k in kernels.items():
            k["share_of_bound"] = bound["bwd_bound_ms"] / k["device_ms"]
            k["sums_wrong_by_design"] = tag in WRONG_SUMS
        print(json.dumps({
            "case": case, "tiles": n_tiles, "tiles_x": tiles_x, "cap": cap,
            "col_slices": binned.bwd_col_slices(n_tiles, cap),
            "slots_live": int(cnt.to(torch.int64).sum()),
            "max_cnt": int(cnt.max()), "full_tiles": int((cnt >= cap).sum()),
            **info, **bound, "kernels": kernels}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

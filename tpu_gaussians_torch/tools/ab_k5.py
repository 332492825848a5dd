#!/usr/bin/env python3
"""Build and time K5 alone on one card, beside other builds of it, and K9a
on the same inputs.

  python3 tpu_gaussians_torch/tools/ab_k5.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/splat_v2_fwd.cu` and each OTHER source (for
example the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/
splat_v2_fwd.cu > _scratch/parent.cu`), each under its own library name in
`_build/`, all nvcc processes started together; prints ptxas' register
lines, the HMMA count and the SASS opcode counts of each build's kernel. A
build whose library exports `splat_v2_fwd_slices` gets its slice scratch
by that count (none for one slice) and takes n_pad; one without it (a
single-pass source) takes neither. --ablations adds copies of this tree's
kernel with a part of its work taken out or changed: no_exp (x = e, no
ex2) and one_mma (one product where there are three, its operands kept
live), whose sums are wrong and which are timed only; one_slice (one slice
of each band's range at every shape), four_slices (4, or n_pad / 128, at
every shape), max_slices (the rule's cap, 16 slices or n_pad / 128, at
every shape), cut_slices (each band's range cut into consecutive pieces,
one a slice, where this tree deals it chunk by chunk), untrimmed (the
rule's power of two, not trimmed to the
slices a range of n_pad rows fills: 16 on the flagship, where 12 are
live), slices_last (the grid with the slice index varying slowest, so
that a band's later slices wait for the whole of the first) and no_skip
(every chunk evaluated, none skipped for all-zero featsop rows: bit for
bit this tree's sums), which are held to the twin like any build.

Its inputs: the flagship EWA accum fit's view 0 at its initial parameters
(800 of capacity 3000: n_pad 3072, 8 bands of 128x128), 8,192 EWA
gaussians on 512x512 (chip_smoke's kernel case), the 100k 512x512 EWA
scene's view 0 on the dense route and the 500k EWA scene's view 0
(chip_smoke's mixed cell, where K5 is the forward), each
staged by ops/splat's own y-sort and band staging (tools/ab_k6.py's
cases). On each, every build is held against the plain twin (rtol/atol
1e-5), against this tree's build (largest difference) and against itself
across two launches (bit for bit); then all are timed in turns (CUDA-event
medians of 20 launches, `--rounds` rounds, the median of the rounds, as
chip_smoke times a kernel: the wrapper's host work is inside it), and each
build's device time per call is read from torch.profiler over 20 calls,
its main kernel and its slice sum apart. Then K9a, for the route
question: the same columns on the tile grid's staging (ops/splat._v1_prep),
timed the same two ways beside its bound, and its sums' largest
difference from this tree's K5 on the frame's pixels. Prints one JSON line
per case, with K5's bound on this card (chip_smoke's `v2_fwd_bound`, the
SM clock read while this tree's build runs) and the card's name and power
limit. This tree's build failing a check fails the run; another build's
failure is reported and it is timed all the same. Needs one NVIDIA GPU and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

import ab_builds
import ab_k6

KERNEL = "splat_v2_fwd"
ABLATIONS = {
    "no_exp": [("split(ex2(e), ab[i], as[i]);", "split(e, ab[i], as[i]);",
                1)],
    "one_mma": [(
        """  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);""",
        """  const uint32_t a[4] = {ab[0] ^ as[0], ab[1] ^ as[1], ab[2] ^ as[2],
                         ab[3] ^ as[3]};
  mma(c, a, bb0 ^ bs0, bb1 ^ bs1);""", 1)],
    "one_slice": [("constexpr int MAX_SLICES = 16;",
                   "constexpr int MAX_SLICES = 1;", 1)],
    "four_slices": [("constexpr int MAX_SLICES = 16;",
                     "constexpr int MAX_SLICES = 4;", 1),
                    ("constexpr int TARGET_PER_SM = 6;",
                     "constexpr int TARGET_PER_SM = 1 << 20;", 1)],
    "max_slices": [("constexpr int TARGET_PER_SM = 6;",
                    "constexpr int TARGET_PER_SM = 1 << 20;", 1)],
    "slices_last": [(
        "const int tile = blockIdx.x / slices, slice = blockIdx.x % slices;",
        "const int tile = blockIdx.x % (gridDim.x / slices),\n"
        "            slice = blockIdx.x / (gridDim.x / slices);", 1)],
    "cut_slices": [
        ("  const int c0 = lo[band] * (nb / CHUNK) + slice;\n",
         "  const int per = (cnt[band] * (nb / CHUNK) + slices - 1) / slices;\n"
         "  const int c0 = lo[band] * (nb / CHUNK) + slice * per;\n", 1),
        ("  const int c1 = (lo[band] + cnt[band]) * (nb / CHUNK);\n",
         "  const int c1 = min((lo[band] + cnt[band]) * (nb / CHUNK), "
         "c0 + per);\n", 1),
        ("c < c1; c += slices)", "c < c1; ++c)", 1),
        ("if (c + slices < c1) issue(c + slices);",
         "if (c + 1 < c1) issue(c + 1);", 1)],
    "untrimmed": [("  return (chunks + per - 1) / per;\n}",
                   "  return slices + 0 * per;\n}", 1)],
    "no_skip": [("    if (!live) continue;                 // every term of "
                 "the chunk is 0\n", "", 1)],
}
WRONG_SUMS = ("no_exp", "one_mma")


def launcher(cs, so: Path):
    """K5 -> acc (8, hw_pad) through the launcher of library `so`, with the
    slice scratch it asks for (a single-pass source takes none)."""
    import torch

    lib = ctypes.CDLL(str(so))
    fn = lib.splat_v2_fwd_launch
    fn.restype = ctypes.c_int
    sliced = hasattr(lib, "splat_v2_fwd_slices")

    def slices(n_bands: int, n_pad: int):
        return lib.splat_v2_fwd_slices(n_bands, n_pad) if sliced else None

    def run(lo, cnt, gdata, hw_pad, width, nb):
        n_bands, n_pad = lo.shape[0], gdata.shape[0]
        out = torch.empty((8, hw_pad), device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if sliced:
            s = slices(n_bands, n_pad)
            part = out if s == 1 else torch.empty((s, 8, hw_pad),
                                                  device="cuda")
            ptrs = (lo, cnt, gdata, part, out)
            ints = (n_bands, width, nb, n_pad)
        else:
            ptrs = (lo, cnt, gdata, out)
            ints = (n_bands, width, nb)
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in ptrs),
                 *(ctypes.c_int(v) for v in ints), stream)
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    run.slices = slices
    return run


def k9a_record(cs, s, acc_k5, width: int, height: int, sms: int,
               rounds: int) -> dict:
    """K9a on the tile grid's staging of the same splats: CUDA-event
    medians (as the builds), device ms per call, its bound, and its sums'
    largest difference from K5's (acc_k5) on the frame's pixels."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v1
    from tpu_gaussians_torch.ops import splat

    hw = width * height
    with torch.no_grad():
        st = splat._v1_prep(s, height, width)
        args = (st.mask, st.gdata, st.hw_pad, width, st.nb, st.tp)
        acc = splat_v1.splat_v1_fwd(*args)
        err = float((acc[:, :hw] - acc_k5[:, :hw]).abs().max())
        times = [cs.time_ms(lambda: splat_v1.splat_v1_fwd(*args), 20)
                 for _ in range(rounds)]
        prof = cs.profile_calls(lambda i: splat_v1.splat_v1_fwd(*args), 20)
        mhz = cs.clock_while(lambda: splat_v1.splat_v1_fwd(*args),
                             statistics.median(times))
        pairs = cs.v1_live_pairs(st.mask, st.gdata, st.nb, st.tp, hw)
        nbytes = st.gdata.numel() * 4 + st.mask.numel() + 8 * st.hw_pad * 4
        ms, term, terms = cs.tensor_core_bound(
            pairs, cs.V1_FWD_ELEMENTWISE_FLOPS_PER_PAIR,
            cs.V1_FWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
    return {"ms": statistics.median(times), "rounds_ms": times,
            "device_ms": prof["device_busy_ms_per_call"], "nb": st.nb,
            "tp": st.tp, "active_pairs": int(st.mask.to(torch.int64).sum()),
            "alive_pairs": pairs, "bound_ms": ms, "bound_term": term,
            "bound_terms_ms": terms, "sm_clock_mhz": mhz,
            "k5_vs_k9a_max_abs_err": err}


def case_500k(cs, seed: int):
    """(case, splats, width, height) of chip_smoke's 500k EWA scene (its
    generator and seed, seeded quaternions) on view 0 of its 512x512 orbit
    views, at its initial parameters."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats

    n, side = 500_000, 512
    arr = cs.scene_arrays(n, seed + 4)
    arr["quats"] = np.random.default_rng(seed + 4).normal(
        size=(n, 4)).astype(np.float32)
    g = make_gaussians(**arr, device="cuda")
    cams = cam.orbit_cameras(4, side, side, device="cuda")
    with torch.no_grad():
        s = splat.y_sorted(prepare_splats(g, cams.view[0], cams.proj[0],
                                          side, side, footprint="ewa"))
    return "500k_ewa_512x512", s, side, side


def main() -> int:
    args, cs = ab_builds.setup(__doc__, ablations=True)

    import torch

    from tpu_gaussians_torch.kernels import build, splat_v2
    from tpu_gaussians_torch.ops import splat

    others = list(args.others) + (
        ab_builds.ablation_sources(build, KERNEL, ABLATIONS)
        if args.ablations else [])
    runs, hmma = ab_builds.load_builds(KERNEL, others,
                                       lambda so: launcher(cs, so))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, s, width, height in (ab_k6.cases(cs, args.seed)
                                    + [case_500k(cs, args.seed)]):
        hw = width * height
        with torch.no_grad():
            st = splat._v2_prep(s, height, width)
        kargs = (st.lo, st.cnt, st.gdata, st.hw_pad, width, st.nb)
        kernels, info = ab_builds.compare(
            cs, f"K5 {case}", runs, hmma, kargs, splat_v2.v2_fwd_plain,
            args.rounds, feature_dim=0,
            split=("splat_v2_fwd_kernel", "splat_v2_fwd_sum_kernel"))
        bound = cs.v2_fwd_bound(st.lo, st.cnt, st.gdata, st.nb, hw,
                                st.hw_pad, sms, info.pop("sm_clock_mhz"))
        n_bands, n_pad = st.lo.shape[0], st.gdata.shape[0]
        for tag, k in kernels.items():
            k["device_ms_slice_sum"] = k.pop("device_ms_second")
            k["share_of_bound"] = bound["bound_ms"] / k["device_ms"]
            k["slices"] = runs[tag].slices(n_bands, n_pad)
            k["sums_wrong_by_design"] = tag in WRONG_SUMS
        with torch.no_grad():
            acc_k5 = runs["tree"](*kargs)
        print(json.dumps({
            "case": case, "n": s.px.shape[0], "n_pad": n_pad, "nb": st.nb,
            "width": width, "height": height, "bands": n_bands,
            "pairs_evaluated": int(st.cnt.to(torch.int64).sum()) * st.nb
            * splat_v2.TP2, **info, **bound, "kernels": kernels,
            "k9a_same_inputs": k9a_record(cs, s, acc_k5, width, height, sms,
                                          args.rounds),
            "device": cs.nvidia_smi_line()}), flush=True)
        del st, kargs, s, acc_k5
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build and time K6 alone on one card, beside other builds of it, and K9b
on the same inputs.

  python3 tpu_gaussians_torch/tools/ab_k6.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/splat_v2_bwd.cu` and each OTHER source (for
example the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/
splat_v2_bwd.cu > _scratch/parent.cu`), each under its own library name in
`_build/`, all nvcc processes started together; prints ptxas' register
lines, the HMMA count and the SASS opcode counts of each build's kernel. A
build whose library exports `splat_v2_bwd_slices` gets its slice scratch
by that count (none for one slice), one without it (the parent's) by
`splat_v2_bwd_split`. --ablations adds copies of this tree's kernel with a
part of its work taken out or changed: no_exp (x = e, no ex2) and one_mma
(one product where there are three, its operands kept live), whose sums
are wrong and which are timed only; one_slice (one pixel slice at every
shape), max_slices (MAX_SLICES = 16 at every shape), unroll1 (one pixel
step a loop turn, where the kernel runs two), piece512 (the cotangent
staged in two buffers of 512 pixels, K9b's, where the kernel keeps a ring
of four of 256), occ4 (launch bounds of four blocks an SM: 128 registers a
thread) and mt1 (a warp per 16 gaussians, six blocks an SM), which are
held to the twin like any build.

Its inputs: the flagship EWA accum fit's view 0 at its initial parameters
(800 of capacity 3000: n_pad 3072, 8 bands of 128x128), 8,192 EWA
gaussians on 512x512 (chip_smoke's kernel case), and the 100k 512x512 EWA
scene's view 0 on the dense route (accum_binned off; K6 takes up to
393,216 gaussians), each staged by ops/splat's own y-sort and band staging,
with a seeded N(0,1) cotangent in the five feature rows of the frame's
pixels. On each, every build is held against the plain twin (K6's
tolerance: rtol 2e-4 and atol 2e-5 times the largest magnitude of the
output column, at least 1), against this tree's build (largest difference)
and against itself across two launches (bit for bit); then all are timed in
turns (CUDA-event medians of 20 launches, `--rounds` rounds, the median of
the rounds, as chip_smoke times a kernel: the wrapper's host work is inside
it), and each build's device time per call is read from torch.profiler
over 20 calls, its main kernel and its slice sum apart. Then K9b, for the
record: the same columns on the tile grid's staging (ops/splat._v1_prep)
with the same cotangent, timed the same two ways beside its bound. Prints
one JSON line per case, with K6's bound on this card (chip_smoke's
`v2_bwd_bound`, the SM clock read while this tree's build runs) and the
card's name and power limit. This tree's build failing a check fails the
run; another build's failure is reported and it is timed all the same.
Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import statistics
import sys
from pathlib import Path

import ab_builds

ROOT = ab_builds.ROOT
KERNEL = "splat_v2_bwd"
ABLATIONS = {
    "no_exp": [(
        "ex[i] = ex2(fmaf(dx, fmaf(L.ah[G], dx, L.bdy[G]), L.cdy2[G]));",
        "ex[i] = fmaf(dx, fmaf(L.ah[G], dx, L.bdy[G]), L.cdy2[G]);", 1)],
    "one_mma": [(
        """  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);""",
        """  const uint32_t a[4] = {ab[0] ^ as[0], ab[1] ^ as[1], ab[2] ^ as[2],
                         ab[3] ^ as[3]};
  mma(c, a, bb0 ^ bs0, bb1 ^ bs1);""", 1)],
    "one_slice": [("constexpr int MAX_SLICES = 16;",
                   "constexpr int MAX_SLICES = 1;", 1)],
    "max_slices": [("constexpr int BLOCKS_PER_SM = 4;",
                    "constexpr int BLOCKS_PER_SM = 1 << 20;", 1)],
    "unroll1": [("#pragma unroll 2\n      for (; q + 8 <= q_end; q += 8)",
                 "#pragma unroll 1\n      for (; q + 8 <= q_end; q += 8)",
                 1)],
    "piece512": [("constexpr int PIECE = 256;", "constexpr int PIECE = 512;",
                  1),
                 ("constexpr int NBUF = 4;", "constexpr int NBUF = 2;", 1)],
    "occ4": [("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 4)",
              1)],
    "mt1": [("constexpr int MT = 2; ", "constexpr int MT = 1; ", 1),
            ("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 6)",
             1)],
}
WRONG_SUMS = ("no_exp", "one_mma")


def launcher(cs, so: Path):
    """K6 -> rows (n_pad, 16) through the launcher of library `so` (every
    build takes the same arguments), with the slice scratch it asks for."""
    import torch

    lib = ctypes.CDLL(str(so))
    fn = lib.splat_v2_bwd_launch
    fn.restype = ctypes.c_int
    sliced = hasattr(lib, "splat_v2_bwd_slices")

    def slices(n_pad: int) -> int:
        return (lib.splat_v2_bwd_slices(n_pad) if sliced
                else lib.splat_v2_bwd_split())

    def run(lo, cnt, gdata, g8, hw_pad, width, nb):
        n_pad = gdata.shape[0]
        s = slices(n_pad)
        out = torch.empty_like(gdata)
        part = out if sliced and s == 1 else torch.empty(
            (s, *gdata.shape), device="cuda")
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (
                     lo, cnt, gdata, g8, part, out)),
                 *(ctypes.c_int(v) for v in (lo.shape[0], width, nb, n_pad)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    run.slices = slices
    return run


def moments_close(out, ref) -> bool:
    """K6's tolerance against its twin (chip_smoke's)."""
    import torch

    scale = torch.clamp(ref.abs().amax(dim=0), min=1.0)
    return not bool(((out - ref).abs() > 2e-4 * ref.abs()
                     + 2e-5 * scale).any())


def cases(cs, seed: int):
    """[(case, splats, width, height)]: the y-sorted EWA splats of the
    flagship EWA accum fit's view 0 at its initial parameters, of 8,192
    EWA gaussians on 512x512 and of the 100k 512x512 EWA scene's view 0."""
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

    def splats(g, view, proj, width, height):
        with torch.no_grad():
            return splat.y_sorted(prepare_splats(g, view, proj, width, height,
                                                 footprint="ewa"))

    cfg = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                    camera_npz=str(ROOT / "assets" / "example_scene"
                                   / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, cams = load_dataset(cfg, device="cuda")
    raw = init_params(torch.Generator().manual_seed(seed), 800, 3000,
                      use_sh=True, use_quats=True, device="cuda")
    side = 512
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    out = [("flagship_ewa_accum_128x128_init",
            splats(activate(raw), cams.view[0], cams.proj[0], cfg.width,
                   cfg.height), cfg.width, cfg.height)]
    for name, n, s in (("8192", 8192, seed + 3), ("100k", 100_000, seed + 2)):
        g = make_gaussians(**cs.scene_arrays(n, s), quats=np.random.
                           default_rng(s).normal(size=(n, 4)).astype(
                               np.float32), device="cuda")
        out.append((f"{name}_ewa_512x512", splats(g, cams_s.view[0],
                                                  cams_s.proj[0], side, side),
                    side, side))
    return out


def k9b_record(cs, s, g8, width: int, height: int, sms: int,
               rounds: int) -> dict:
    """K9b on the tile grid's staging of the same splats and cotangent:
    CUDA-event medians (as the builds), device ms per call, its bound."""
    import torch

    from tpu_gaussians_torch.kernels import splat_v1
    from tpu_gaussians_torch.ops import splat

    with torch.no_grad():
        st = splat._v1_prep(s, height, width)
        cs.check(st.hw_pad == g8.shape[1], "band and tile padding differ")
        args = (st.mask, st.gdata, g8, st.hw_pad, width, st.nb, st.tp)
        times = [cs.time_ms(lambda: splat_v1.splat_v1_bwd(*args), 20)
                 for _ in range(rounds)]
        prof = cs.profile_calls(lambda i: splat_v1.splat_v1_bwd(*args), 20)
        mhz = cs.clock_while(lambda: splat_v1.splat_v1_bwd(*args),
                             statistics.median(times))
    return {"ms": statistics.median(times), "rounds_ms": times,
            "device_ms": prof["device_busy_ms_per_call"], "nb": st.nb,
            "tp": st.tp, "active_pairs": int(st.mask.to(torch.int64).sum()),
            **cs.v1_bwd_bound(st.mask, st.gdata, st.nb, st.tp,
                              width * height, st.hw_pad, sms, mhz)}


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
    for case, s, width, height in cases(cs, args.seed):
        hw = width * height
        with torch.no_grad():
            st = splat._v2_prep(s, height, width)
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 6)
        g8 = torch.zeros((8, st.hw_pad), device="cuda")
        g8[:5, :hw] = torch.randn((5, hw), generator=gen, device="cuda")
        kargs = (st.lo, st.cnt, st.gdata, g8, st.hw_pad, width, st.nb)
        kernels, info = ab_builds.compare(
            cs, f"K6 {case}", runs, hmma, kargs, splat_v2.v2_bwd_plain,
            args.rounds, feature_dim=1,
            split=("splat_v2_bwd_kernel", "segment_sum_kernel"),
            close=moments_close)
        bound = cs.v2_bwd_bound(st.lo, st.cnt, st.gdata, st.nb, hw,
                                st.hw_pad, sms, info.pop("sm_clock_mhz"))
        n_pad = st.gdata.shape[0]
        for tag, k in kernels.items():
            k["device_ms_slice_sum"] = k.pop("device_ms_second")
            k["share_of_bound"] = bound["bwd_bound_ms"] / k["device_ms"]
            k["slices"] = runs[tag].slices(n_pad)
            k["sums_wrong_by_design"] = tag in WRONG_SUMS
        print(json.dumps({
            "case": case, "n": s.px.shape[0], "n_pad": n_pad, "nb": st.nb,
            "width": width, "height": height, "bands": st.lo.shape[0],
            "pairs_evaluated": int(st.cnt.to(torch.int64).sum()) * st.nb
            * splat_v2.TP2,
            "alive_pairs": cs.v2_alive_pairs(st.lo, st.cnt, st.gdata, st.nb,
                                             hw),
            **info, **bound, "kernels": kernels,
            "k9b_same_inputs": k9b_record(cs, s, g8, width, height, sms,
                                          args.rounds)}), flush=True)
        del st, g8, kargs, s
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

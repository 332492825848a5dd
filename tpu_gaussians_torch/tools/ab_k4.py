#!/usr/bin/env python3
"""Build and time K4 alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k4.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/sorted_bwd.cu` and each OTHER source (for example
the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/sorted_bwd.cu
> _scratch/parent.cu`; a source whose launcher takes no walk counter is
called without one), each under its own library name in `_build/`, all
nvcc processes started together; prints ptxas' register lines.
--ablations adds copies of this tree's kernel with its culling taken out
(no_cull: every slot listed for every warp) or cut to one level
(one_level_cull: a slot listed for each warp its x-extent meets, whatever
its rows), held to the twin like any build.

Cases, at initial parameters (not trained), each with this tree's K3's
acc and chunks_done and a seeded N(0,1) cotangent: the flagship EWA sorted
fit's view 0 (800 gaussians at capacity 4096 from the fit's own
initialisation with --use_sh and seed --seed, pair budget measured as the
fit does), where large gaussians cover most of each tile; chip_smoke's
phase-10 100k 512x512 scene with seeded quaternions, view 0, both
footprints; and the benchmark's fit cell (`fit_100k_ewa_sorted_1080p`:
100k EWA SH3 gaussians at 1920x1080, from gsbench's own inputs at seed
--seed), pool view 0, its pair budget by `auto_pair_k` over the pool
(chip_smoke's `fit_cell_view0`).

On each, every build is held against the plain twin at K4's tolerance
(2e-3 |ref| + 2e-4 x the column's largest), against itself across two
launches (bit for bit) and against this tree's build (`torch.equal`: ==,
so +0 and -0 agree); then all are timed in turns (CUDA-event medians of
20 launches, `--rounds` rounds, the median of the rounds: the launcher's
host work is inside it), and each build's device time per call is read
from torch.profiler over 20 calls. Prints one JSON line per case with the
composited slots, the walks this tree's lists held (its counter) and their
share, the pairs the CPU mirror's rule evaluates (`cull_counts`, run on
the card, where torch divides by a scalar through its reciprocal: so
whether the counter equals it is reported, not required), the live pairs
(a_raw >= 1e-5), K4's all-pairs bound (chip_smoke's
operations per composited pair), and each build's share of it; then
whether each build equals this tree's on every case, and the card's name
and power limit. This tree's build failing a check fails the run; another
build's failure is reported and it is timed all the same. Needs one
NVIDIA GPU and nvcc.
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
KERNEL = "sorted_bwd"
FIT_CELL = "fit_100k_ewa_sorted_1080p"
# name: [(snippet of csrc/sorted_bwd.cu, replacement, occurrences)]
ABLATIONS = {
    "no_cull": [("constexpr bool CULL = true;",
                 "constexpr bool CULL = false;", 1)],
    "one_level_cull": [("constexpr bool ROW_CULL = true;",
                        "constexpr bool ROW_CULL = false;", 1)],
}


def takes_walks(source: Path) -> bool:
    """Whether the launcher in `source` takes the walk counter."""
    text = source.read_text()
    return "walks" in text.split("sorted_bwd_launch(", 1)[1].split(")")[0]


def launcher(cs, so: Path, walks_arg: bool):
    """K4 -> raw rows (n_tiles*cap, 16) through the launcher of library
    `so`; `walks` (2,) int64 gets the counter where the source takes one."""
    import torch

    fn = ctypes.CDLL(str(so)).sorted_bwd_launch
    fn.restype = ctypes.c_int

    def run(gdense, cnt, acc, g8, chunks, tiles_x, axis, walks=None):
        n_tiles = cnt.shape[0]
        out = torch.empty_like(gdense)
        ptrs = [ctypes.c_void_p(t.data_ptr())
                for t in (gdense, cnt, acc, g8, chunks, out)]
        if walks_arg:
            ptrs.append(ctypes.c_void_p(
                None if walks is None else walks.data_ptr()))
        err = fn(*ptrs, *(ctypes.c_int(v) for v in (
            tiles_x, n_tiles, gdense.shape[0] // n_tiles, int(axis))),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    return run


def k4_cases(cs, seed: int):
    """Yields (case, footprint, gdense, cnt, tiles_x) for the inputs of the
    module docstring, one at a time."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, init_params)
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z
    from tpu_gaussians_torch.utils.config import FitConfig

    def lists(g, view, proj, width, height, footprint, pair_k):
        with torch.no_grad():
            s = prepare_splats(g, view, proj, width, height,
                               footprint=footprint)
            gdense, cnt, tiles_x, _, _ = tiled.tile_lists(
                s, camera_z(g.means, view), height, width, 0, pair_k)
        return gdense, cnt, tiles_x

    cfg = FitConfig(targets_dir=str(ROOT / "assets" / "example_scene"),
                    camera_npz=str(ROOT / "assets" / "example_scene"
                                   / "cameras.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, cams = load_dataset(cfg, device="cuda")
    g_f = activate(init_params(torch.Generator().manual_seed(seed), 800,
                               4096, use_sh=True, use_quats=True,
                               device="cuda"))
    k_f = tiled.auto_pair_k(g_f, cams.view, cams.proj, cfg.width,
                            cfg.height, footprint="ewa")
    yield ("flagship_ewa_128x128_init", "ewa", *lists(
        g_f, cams.view[0], cams.proj[0], cfg.width, cfg.height, "ewa", k_f))

    side, n = 512, 100_000
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    arr = cs.scene_arrays(n, seed + 2)
    arr["quats"] = np.random.default_rng(seed + 2).normal(
        size=(n, 4)).astype(np.float32)
    g_e = make_gaussians(**arr, device="cuda")
    k_s = tiled.auto_pair_k(g_e, cams_s.view, cams_s.proj, side, side,
                            footprint="ewa")
    for fp in ("ewa", "axis"):
        yield (f"100k_512x512_{fp}_init", fp, *lists(
            g_e, cams_s.view[0], cams_s.proj[0], side, side, fp, k_s))
    del g_e

    g, view, proj, width, height, k = cs.fit_cell_view0(seed)
    yield (f"{FIT_CELL}_view0", "ewa", *lists(
        g, view, proj, width, height, "ewa", k))


def main() -> int:
    args, cs = ab_builds.setup(__doc__, ablations=True)

    import torch

    from tpu_gaussians_torch.kernels import build, sorted_bwd, sorted_fwd
    from tpu_gaussians_torch.ops.binning import ALPHA_CUTOFF, EXIT_T, NBS, TPS

    others = list(args.others) + (
        ab_builds.ablation_sources(build, KERNEL, ABLATIONS)
        if args.ablations else [])
    sources = {build.library_path(KERNEL): build.CSRC / f"{KERNEL}.cu"}
    sources.update({build.BUILD / f"{KERNEL}_{p.stem}.so": p for p in others})
    runs, _ = ab_builds.load_builds(
        KERNEL, others,
        lambda so: launcher(cs, so, takes_walks(sources[so])), sass=False)
    names = list(runs)
    same_everywhere = {tag: True for tag in names}
    for case, footprint, gdense, cnt, tiles_x in k4_cases(cs, args.seed):
        axis = footprint == "axis"
        with torch.no_grad():
            acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, tiles_x,
                                                  axis=axis, exit_t=EXIT_T)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            g8 = torch.randn(acc.shape, generator=gen, device="cuda")
            kargs = (gdense, cnt, acc, g8, chunks, tiles_x, axis)
            ref, plain_ms = cs.timed(
                lambda: sorted_bwd.sorted_bwd_plain(*kargs), 1)
            scale = ref.abs().amax(dim=0)
            walks = torch.zeros(2, dtype=torch.int64, device="cuda")
            tree = runs["tree"](*kargs, walks=walks)
            walked, slots = (int(v) for v in walks.tolist())
            kernels = {}
            for tag in names:
                out = runs[tag](*kargs)
                again = runs[tag](*kargs)
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(out).all()) and not bool((
                    (out - ref).abs() > 2e-3 * ref.abs() + 2e-4 * scale
                ).any())
                same = bool(torch.equal(out, tree))
                same_everywhere[tag] &= same
                kernels[tag] = {
                    "twin_ok": ok,
                    "max_abs_err": float((out - ref).abs().max()),
                    "bitwise_repeat": bool(torch.equal(out, again)),
                    "equal_to_tree": same}
                if tag == "tree":
                    cs.check(ok, f"K4 {case}: disagrees with its twin "
                             f"({kernels[tag]['max_abs_err']})")
                    cs.check(kernels[tag]["bitwise_repeat"],
                             f"K4 {case}: not deterministic")
            del out, again, ref, tree
            times = {tag: [] for tag in names}
            for _ in range(args.rounds):
                for tag in names + names[::-1]:
                    times[tag].append(cs.time_ms(
                        lambda: runs[tag](*kargs), 20))
            for tag in names:
                prof = cs.profile_calls(lambda i: runs[tag](*kargs), 20)
                kernels[tag].update(
                    ms=statistics.median(times[tag]), rounds_ms=times[tag],
                    device_ms=prof["port_kernels"].get(
                        "sorted_bwd_kernel", (None,))[0])
            counts = sorted_fwd.cull_counts(gdense, cnt, chunks, tiles_x,
                                            axis)
        composited = int(torch.minimum(cnt, chunks * NBS).sum())
        bound_ms = 1e3 * cs.SORTED_BWD_FLOPS_PER_EVAL[footprint] * (
            composited * TPS) / cs.F32_FLOPS_PER_S
        for k in kernels.values():
            k["share_of_bound"] = (bound_ms / k["device_ms"]
                                   if k["device_ms"] else None)
        n_tiles = cnt.shape[0]
        print(json.dumps({
            "case": case, "footprint": footprint, "tiles": n_tiles,
            "tiles_x": tiles_x, "cap": gdense.shape[0] // n_tiles,
            "slots_listed": int(cnt.sum()), "slots_composited": composited,
            "chunks_done": int(chunks.sum()), "walked": walked,
            "walks_unculled": slots,
            "walked_share": walked / slots if slots else None,
            "composited_pairs": counts["composited_pairs"],
            "evaluated_pairs": counts["evaluated_pairs"],
            "live_pairs": counts["live_pairs"],
            "counter_equals_mirror": (
                walked * sorted_bwd.WALK_PIXELS == counts["evaluated_pairs"]),
            "live_cutoff": ALPHA_CUTOFF, "bound_ms": bound_ms,
            "bound_by": "operations", "plain_ms": plain_ms,
            "kernels": kernels}), flush=True)
        del gdense, cnt, acc, g8
    print("equal to this tree's build on every case: "
          + json.dumps(same_everywhere), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

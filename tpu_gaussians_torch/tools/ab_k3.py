#!/usr/bin/env python3
"""Build and time K3 alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k3.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/sorted_fwd.cu` and each OTHER source (for example
the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/sorted_fwd.cu
> _scratch/parent.cu`; it takes the same launcher arguments), each under
its own library name in `_build/`, all nvcc processes started together;
prints ptxas' register lines. --ablations adds copies of this tree's kernel
with a part of its design taken out or changed, all of them held to the
twin like any build: no_cull (every slot listed for every warp),
one_level_cull (the warp level only: a slot listed for each warp its
x-extent meets, whatever its rows), block_list (one list for the block, of
the slots whose extent meets its rows and any warp's columns, which each
warp walks, skipping the slots outside its columns), no_row_table (axis:
the row factor op exp(-0.5 c dy^2) per thread and pixel, as before the
culling), four_blocks_of_four_rows (clusters of 4 blocks of 4 rows) and
half_chunk_staging (256 slots staged and listed at a time, the exit test
still per 512).

Then builds chip_smoke's six K3 inputs: its three served frames (the
100,000- and 1,000,000-gaussian scenes of phases 3 and 5 at 960x540, orbit
view 1, the interactive and quality presets' pair budget, capacity and
exit_t; axis footprint) and the lists of its three sorted fits' cases at
their initial parameters, not trained (the flagship EWA sorted fit's view 0:
800 gaussians at capacity 4096 from the fit's own initialisation with
--use_sh and seed --seed, pair budget measured as the fit does; and phase
10's 100k 512x512 scene with seeded quaternions, view 0, both footprints).
On each, every build is held against the plain twin with chip_smoke's
`sorted_fwd_agreement` (image and alpha within rtol 1e-4 / atol 1e-5,
within exit_t on tiles whose exit differs), against itself across two
launches (bit for bit) and against this tree's build (acc and chunks_done
bit for bit); then all are timed in turns (CUDA-event medians of 20
launches, `--rounds` rounds, the median of the rounds: the launcher's host
work is inside it), and each build's device time per call is read from
torch.profiler over 20 calls. Prints one JSON line per case with K3's
all-pairs bound (chip_smoke's `sorted_fwd_bound`) and live bound
(`sorted_fwd_live_bound`: the live and evaluated pairs, the SM clock read
while this tree's build runs), each build's shares of both, and the card's
name and power limit. This tree's build failing a check fails the run;
another build's failure is reported and it is timed all the same. Needs
one NVIDIA GPU and nvcc.
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
KERNEL = "sorted_fwd"
# name: [(snippet of csrc/sorted_fwd.cu, replacement, occurrences)]
ABLATIONS = {
    "no_cull": [("constexpr bool CULL = true;",
                 "constexpr bool CULL = false;", 1)],
    "one_level_cull": [("constexpr bool ROW_CULL = true;",
                        "constexpr bool ROW_CULL = false;", 1)],
    "block_list": [("constexpr bool WARP_LISTS = true;",
                    "constexpr bool WARP_LISTS = false;", 1)],
    "no_row_table": [("constexpr bool ROW_TABLE = true;",
                      "constexpr bool ROW_TABLE = false;", 1)],
    "four_blocks_of_four_rows": [("constexpr int S = 8;",
                                  "constexpr int S = 4;", 1)],
    "half_chunk_staging": [("constexpr int STAGE = NBS;",
                            "constexpr int STAGE = NBS / 2;", 1)],
}


def launcher(cs, so: Path):
    """K3 -> (acc (8, n_tiles*2048), chunks_done (n_tiles,)) through the
    launcher of library `so`."""
    import torch

    fn = ctypes.CDLL(str(so)).sorted_fwd_launch
    fn.restype = ctypes.c_int

    def run(gdense, cnt, tiles_x, axis, exit_t):
        n_tiles = cnt.shape[0]
        out = torch.empty((8, n_tiles * 2048), device="cuda")
        chunks = torch.empty((n_tiles,), dtype=torch.int32, device="cuda")
        err = fn(*(ctypes.c_void_p(t.data_ptr())
                   for t in (gdense, cnt, out, chunks)),
                 *(ctypes.c_int(v) for v in (tiles_x, n_tiles,
                                             gdense.shape[0] // n_tiles)),
                 ctypes.c_float(exit_t), ctypes.c_int(int(axis)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out, chunks

    return run


def k3_cases(cs, seed: int):
    """[(case, footprint, (gdense, cnt, tiles_x, tiles_y, height, width,
    exit_t))] for the six inputs of the module docstring."""
    import numpy as np
    import torch

    from tpu_gaussians_torch.cli.serve import INTERACTIVE_KNOBS
    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import RenderConfig, make_gaussians
    from tpu_gaussians_torch.fit.trainer import load_dataset
    from tpu_gaussians_torch.models.gaussian_model import (
        activate, init_params)
    from tpu_gaussians_torch.ops import sorted as tiled
    from tpu_gaussians_torch.ops.binning import EXIT_T
    from tpu_gaussians_torch.ops.common import prepare_splats
    from tpu_gaussians_torch.ops.projection import camera_z
    from tpu_gaussians_torch.utils.config import FitConfig

    def lists(g, view, proj, width, height, footprint, capacity, pair_k,
              exit_t):
        with torch.no_grad():
            s = prepare_splats(g, view, proj, width, height,
                               footprint=footprint)
            gdense, cnt, tiles_x, tiles_y, _ = tiled.tile_lists(
                s, camera_z(g.means, view), height, width, capacity, pair_k)
        return gdense, cnt, tiles_x, tiles_y, height, width, exit_t

    cases = []
    width, height = 960, 540
    c = cam.orbit_cameras(8, width, height, device="cuda")[1]
    g100 = make_gaussians(**cs.scene_arrays(100_000, seed), device="cuda")
    g1m = make_gaussians(**cs.scene_arrays(1_000_000, seed + 1),
                         device="cuda")
    for name, g, knobs in (
            ("100k_960x540_interactive", g100, INTERACTIVE_KNOBS),
            ("100k_960x540_quality", g100, {}),
            ("1M_960x540_interactive", g1m, INTERACTIVE_KNOBS)):
        cfg = RenderConfig(width=width, height=height, mode="sorted",
                           **knobs)
        cases.append((name, "axis", lists(
            g, c.view, c.proj, width, height, "axis",
            cfg.sorted_band_capacity, cfg.sorted_pair_k,
            cfg.sorted_exit_t or EXIT_T)))
    del g1m

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
    cases.append(("flagship_ewa_128x128_init", "ewa", lists(
        g_f, cams.view[0], cams.proj[0], cfg.width, cfg.height, "ewa", 0,
        k_f, EXIT_T)))

    side, n = 512, 100_000
    cams_s = cam.orbit_cameras(4, side, side, device="cuda")
    arr = cs.scene_arrays(n, seed + 2)
    arr["quats"] = np.random.default_rng(seed + 2).normal(
        size=(n, 4)).astype(np.float32)
    g_e = make_gaussians(**arr, device="cuda")
    k_s = tiled.auto_pair_k(g_e, cams_s.view, cams_s.proj, side, side,
                            footprint="ewa")
    for fp in ("ewa", "axis"):
        cases.append((f"100k_512x512_{fp}_init", fp, lists(
            g_e, cams_s.view[0], cams_s.proj[0], side, side, fp, 0, k_s,
            EXIT_T)))
    return cases


def main() -> int:
    args, cs = ab_builds.setup(__doc__, ablations=True)

    import torch

    from tpu_gaussians_torch.kernels import build, sorted_fwd

    others = list(args.others) + (
        ab_builds.ablation_sources(build, KERNEL, ABLATIONS)
        if args.ablations else [])
    runs, _ = ab_builds.load_builds(KERNEL, others,
                                    lambda so: launcher(cs, so), sass=False)
    names = list(runs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    same_everywhere = {tag: True for tag in names}
    for case, footprint, (gdense, cnt, tiles_x, tiles_y, height, width,
                          exit_t) in k3_cases(cs, args.seed):
        axis = footprint == "axis"
        kargs = (gdense, cnt, tiles_x, axis, exit_t)
        with torch.no_grad():
            (acc_p, chunks_p), plain_ms = cs.timed(
                lambda: sorted_fwd.sorted_tiles_plain(
                    gdense, cnt, tiles_x, axis=axis, exit_t=exit_t), 3)
            tree = runs["tree"](*kargs)
            kernels = {}
            for tag in names:
                acc, chunks = runs[tag](*kargs)
                again, chunks_again = runs[tag](*kargs)
                torch.cuda.synchronize()
                ok, err, differ = cs.sorted_fwd_agreement(
                    acc, chunks, acc_p, chunks_p, tiles_y, tiles_x, height,
                    width, exit_t)
                same = (torch.equal(acc, tree[0])
                        and torch.equal(chunks, tree[1]))
                same_everywhere[tag] &= same
                kernels[tag] = {
                    "twin_ok": ok, "max_abs_err": err,
                    "tiles_exit_differs": differ,
                    "bitwise_repeat": (torch.equal(acc, again)
                                       and torch.equal(chunks, chunks_again)),
                    "bit_identical_to_tree": same}
                if tag == "tree":
                    cs.check(ok, f"K3 {case}: disagrees with its twin ({err})")
                    cs.check(kernels[tag]["bitwise_repeat"],
                             f"K3 {case}: not deterministic")
            del acc, again, acc_p
            times = {tag: [] for tag in names}
            for _ in range(args.rounds):
                for tag in names + names[::-1]:
                    times[tag].append(cs.time_ms(
                        lambda: runs[tag](*kargs), 20))
            for tag in names:
                prof = cs.profile_calls(lambda i: runs[tag](*kargs), 20)
                kernels[tag].update(
                    ms=statistics.median(times[tag]), rounds_ms=times[tag],
                    device_ms=prof["port_kernels"]["sorted_fwd_kernel"][0])
            mhz = cs.sorted_fwd_clock(lambda: runs["tree"](*kargs))
        bound = cs.sorted_fwd_bound(cnt, tree[1], footprint)
        live = cs.sorted_fwd_live_bound(gdense, cnt, tree[1], tiles_x,
                                        footprint, sms, mhz)
        for k in kernels.values():
            k["share_of_bound"] = bound["bound_ms"] / k["device_ms"]
            k["share_of_live_bound"] = live["live_bound_ms"] / k["device_ms"]
        n_tiles = cnt.shape[0]
        print(json.dumps({
            "case": case, "footprint": footprint, "tiles": n_tiles,
            "tiles_x": tiles_x, "cap": gdense.shape[0] // n_tiles,
            "exit_t": exit_t, "slots_listed": int(cnt.sum()),
            "chunks_done": int(tree[1].sum()), "plain_ms": plain_ms,
            **bound, **live, "kernels": kernels}), flush=True)
        del tree
    print("bit-identical to this tree's build on every case: "
          + json.dumps(same_everywhere), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

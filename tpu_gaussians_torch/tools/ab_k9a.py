#!/usr/bin/env python3
"""Build and time K9a alone on one card, beside other builds of it.

  python3 tpu_gaussians_torch/tools/ab_k9a.py [OTHER.cu ...] [--ablations]
      [--rounds 3] [--seed 0]

Builds this tree's `csrc/splat_v1_fwd.cu` and each OTHER source (for
example the parent's copy: `git show HEAD~1:tpu_gaussians_torch/csrc/
splat_v1_fwd.cu > _scratch/parent.cu`), each under its own library name in
`_build/`, all nvcc processes started together; prints ptxas' register
lines and the HMMA count of each build's kernel. --ablations adds copies
of this tree's kernel with a part of its work taken out, for their times
only (their sums are wrong): no_exp (w = e, no ex2), one_mma (one product
where there are three, its operands kept live), neither (both), and
staged_once (the first chunk staged, every chunk's math run on it: no
copies, turns or barriers after it). Then stages two cases of
chip_smoke's through `ops/splat._v1_prep`: view 0 of its 1M exact scene
(phase 17's generator at its initial parameters; 4 orbit views at
512x512) and its 8,192-gaussian case. On each, every build is held against
the plain twin (rtol/atol 1e-5), against this tree's build (largest
difference) and against itself across two launches (bit for bit), then
all are timed in turns, forwards then backwards (CUDA-event medians of 5
launches at 1M and 20 at 8,192, `--rounds` rounds, the median of the
rounds). Prints one JSON line per case, with K9a's bound on this card
(chip_smoke's terms, the SM clock read while this tree's build runs), and
the card's name and power limit. This tree's build failing a check fails
the run; another build's failure is reported and it is timed all the same.
Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNEL = "splat_v1_fwd"
NO_EXP = ("split(ex2(e), ab[i], as[i]);", "split(e, ab[i], as[i]);")
MMA3 = """      mma3(d[m], ab, as, __float_as_uint(b.x), __float_as_uint(b.y),
           __float_as_uint(b.z), __float_as_uint(b.w));"""
ONE_MMA = (MMA3, "      mma(d[m], ab, __float_as_uint(b.x) ^ as[0], "
           "__float_as_uint(b.y) ^ as[3]);")
STAGE = """    asm volatile("cp.async.wait_group 0;");
    __syncthreads();   // the chunk has landed; the last chunk's math is over
    turn(S, threadIdx.x);
    __syncthreads();   // turned; the raw buffer is free
    if (cn < end) issue(cn);
    asm volatile("cp.async.commit_group;");"""
ABLATIONS = {
    "no_exp": [NO_EXP], "one_mma": [ONE_MMA], "neither": [NO_EXP, ONE_MMA],
    "staged_once": [(STAGE, "    if (c == first) {\n" + STAGE + "\n    }"),
                    ("  int c = next(-1);\n",
                     "  int c = next(-1);\n  const int first = c;\n")]}


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


def launcher(cs, so: Path):
    """K9a -> acc (8, hw_pad) through the launcher of library `so`."""
    import torch

    fn = ctypes.CDLL(str(so)).splat_v1_fwd_launch
    fn.restype = ctypes.c_int

    def run(mask, gdata, hw_pad, width, nb, tp):
        out = torch.empty((8, hw_pad), device="cuda")
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (mask, gdata, out)),
                 *(ctypes.c_int(v) for v in (mask.shape[0], mask.shape[1],
                                             width, nb, tp)),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cs.check(err == 0, f"{so.name}: CUDA error {err}")
        return out

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("others", nargs="*", type=Path)
    ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from tpu_gaussians_torch.core import camera as cam
    from tpu_gaussians_torch.core.types import make_gaussians, resolve_device
    from tpu_gaussians_torch.kernels import build, splat_v1
    from tpu_gaussians_torch.ops import splat
    from tpu_gaussians_torch.ops.common import prepare_splats

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    resolve_device("cuda")
    libs = build.build_others(KERNEL, args.others + (
        ablation_sources(build) if args.ablations else []))
    runs = {}
    for tag, (so, text) in libs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {tag}: {line.strip()}", flush=True)
        hmma = build.sass_count(so, f"{KERNEL}_kernel", "HMMA")
        print(f"build {tag}: {hmma} HMMA instructions in the kernel's SASS",
              flush=True)
        runs[tag] = launcher(cs, so)
    names = list(runs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    side = 512
    cams = cam.orbit_cameras(4, side, side, device="cuda")
    for case, n, seed_off, reps in (("1M_ewa_512x512", 1_000_000, 1, 5),
                                    ("8192_ewa_512x512", 8192, 3, 20)):
        arr = cs.scene_arrays(n, args.seed + seed_off)
        arr["quats"] = np.random.default_rng(args.seed + seed_off).normal(
            size=(n, 4)).astype(np.float32)
        with torch.no_grad():
            s = splat.y_sorted(prepare_splats(
                make_gaussians(**arr, device="cuda"), cams.view[0],
                cams.proj[0], side, side, footprint="ewa"))
            mask, gdata, nb, tp, hw_pad = splat._v1_prep(s, side, side)
            kargs = (mask, gdata, hw_pad, side, nb, tp)
            ref, plain_ms = cs.timed(lambda: splat_v1.v1_fwd_plain(*kargs), 1)
            tree = runs["tree"](*kargs)
            kernels = {}
            for tag in names:
                acc = runs[tag](*kargs)
                again = runs[tag](*kargs)
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(acc).all()
                          and torch.allclose(acc, ref, rtol=1e-5, atol=1e-5))
                kernels[tag] = {
                    "twin_ok": ok, "bitwise_repeat": bool(torch.equal(acc,
                                                                      again)),
                    "max_abs_err": float((acc - ref).abs().max()),
                    "vs_tree_max_abs_diff": float((acc - tree).abs().max())}
                if tag == "tree":
                    cs.check(ok, f"{case}: K9a disagrees with its twin "
                             f"({kernels[tag]['max_abs_err']})")
                    cs.check(kernels[tag]["bitwise_repeat"],
                             f"{case}: K9a not deterministic")
            del ref, tree, acc, again
            rounds = {tag: [] for tag in names}
            for _ in range(args.rounds):
                for tag in names + names[::-1]:
                    rounds[tag].append(cs.time_ms(lambda: runs[tag](*kargs),
                                                  reps))
            ms = {tag: statistics.median(r) for tag, r in rounds.items()}
            for _ in range(max(1, int(300 / max(ms["tree"], 1e-3)))):
                runs["tree"](*kargs)
            mhz = cs.sm_clock_mhz()
            torch.cuda.synchronize()
        pairs = cs.v1_live_pairs(mask, gdata, nb, tp, side * side)
        nbytes = gdata.numel() * 4 + mask.numel() + 8 * hw_pad * 4
        bound, term, terms = cs.tensor_core_bound(
            pairs, cs.V1_FWD_ELEMENTWISE_FLOPS_PER_PAIR,
            cs.V1_FWD_PRODUCT_FLOPS_PER_PAIR, nbytes, sms, mhz)
        for tag in names:
            kernels[tag].update(ms=ms[tag], rounds_ms=rounds[tag],
                                share_of_bound=bound / ms[tag])
        print(json.dumps({
            "case": case, "n_pad": gdata.shape[0], "nb": nb, "tp": tp,
            "tiles": mask.shape[0], "blocks": mask.shape[1],
            "active_pairs": int(mask.to(torch.int64).sum()),
            "alive_pairs": pairs, "plain_ms": plain_ms, "sm_clock_mhz": mhz,
            "bound_ms": bound, "bound_term": term, "bound_terms_ms": terms,
            "bound_ms_26flop": max(
                1e3 * cs.V1_FWD_FLOPS_PER_PAIR * pairs / cs.F32_FLOPS_PER_S,
                1e3 * nbytes / cs.HBM_BYTES_PER_S),
            "kernels": kernels}), flush=True)
        del mask, gdata, s
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

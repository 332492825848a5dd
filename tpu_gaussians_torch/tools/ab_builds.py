"""The shared body of the single-kernel probes `tools/ab_k1.py`,
`tools/ab_k2.py`, `tools/ab_k3.py`, `tools/ab_k5.py`, `tools/ab_k6.py`,
`tools/ab_k7a.py`, `tools/ab_k7b.py`, `tools/ab_k8a.py` and
`tools/ab_k8b.py`: build this
tree's source of one kernel beside other sources of it, hold every build
against the plain twin and against itself, and time the builds in turns.

Not a script: each probe builds its own cases and bound and calls `setup`,
`load_builds` and `compare` (K3, whose output is a pair and whose check is
chip_smoke's, its own loop), and `ablation_sources` for its --ablations.
Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def setup(doc: str, ablations: bool = False):
    """(parsed arguments, chip_smoke.py of this checkout imported as a
    module) for a probe whose usage is `doc`: OTHER.cu sources, --rounds,
    --seed, and --ablations for a probe that has them. Fails without a
    card; sets the port's CUDA defaults."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("others", nargs="*", type=Path)
    if ablations:
        ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from tpu_gaussians_torch.core.types import resolve_device

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    resolve_device("cuda")
    return args, cs


def ablation_sources(build, kernel: str, ablations: dict):
    """The --ablations copies of this tree's `csrc/<kernel>.cu`, written to
    _build/<name>.cu: ablations maps a name to its edits (snippet,
    replacement, occurrences), each snippet found exactly that often."""
    src = (build.CSRC / f"{kernel}.cu").read_text()
    build.BUILD.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, edits in ablations.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {text.count(old)} of the "
                                   f"snippet in {kernel}.cu, not {count}")
            text = text.replace(old, new)
        paths.append(build.BUILD / f"{name}.cu")
        paths[-1].write_text(text)
    return paths


def load_builds(kernel: str, others, launcher, sass: bool = True):
    """({tag: run}, {tag: HMMA count}) for this tree's build of `kernel`
    (tag "tree") and each other source (tag: its stem), all built together
    by `kernels/build.build_others`; run = launcher(library path). Prints
    ptxas' register and spill lines and, with `sass`, each build's HMMA
    count (None for another source whose kernel is not one function, e.g.
    a template built for two band heights) and SASS opcode counts
    (`kernels/build.sass_opcodes`); without it the counts are None."""
    from tpu_gaussians_torch.kernels import build

    runs, hmma = {}, {}
    for tag, (so, text) in build.build_others(kernel, others).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {tag}: {line.strip()}", flush=True)
        runs[tag] = launcher(so)
        hmma[tag] = None
        if not sass:
            continue
        try:
            hmma[tag] = build.sass_count(so, f"{kernel}_kernel", "HMMA")
        except RuntimeError:
            if tag == "tree":
                raise
        print(f"build {tag}: {hmma[tag]} HMMA instructions in the kernel's "
              f"SASS", flush=True)
        if hmma[tag] is not None:
            print(f"build {tag}: SASS opcodes "
                  + json.dumps(build.sass_opcodes(so, f"{kernel}_kernel")),
                  flush=True)
    return runs, hmma


def forward_close(out, ref) -> bool:
    """The forwards' tolerance against their twins: rtol/atol 1e-5."""
    import torch

    return bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-5))


def compare(cs, case: str, runs: dict, hmma: dict, kargs, twin,
            rounds: int, feature_dim: int, split=None, close=forward_close):
    """Every build on one case's inputs `kargs`: against the plain twin
    (`close`, by default the forwards' rtol/atol 1e-5), this tree's build
    (largest difference) and itself across two launches (bit for bit),
    then timed in turns (CUDA-event medians of 20 launches, `rounds`
    rounds, the median of the rounds: the wrapper's host work is inside
    it) and by torch.profiler device time per call over 20 calls; with
    split = (main, second), each build's device time also apart for the
    kernels whose names hold them. This tree's build failing a check
    raises. -> ({tag: results}, {plain_ms,
    max_abs_ref, max_abs_ref_by_feature (over `feature_dim` of the
    output), sm_clock_mhz (read while this tree's build runs)})."""
    import torch

    names = list(runs)
    with torch.no_grad():
        ref, plain_ms = cs.timed(lambda: twin(*kargs), 5)
        tree = runs["tree"](*kargs)
        kernels = {}
        for tag in names:
            acc = runs[tag](*kargs)
            again = runs[tag](*kargs)
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(acc).all()) and close(acc, ref)
            kernels[tag] = {
                "twin_ok": ok, "bitwise_repeat": bool(torch.equal(acc, again)),
                "max_abs_err": float((acc - ref).abs().max()),
                "vs_tree_max_abs_diff": float((acc - tree).abs().max()),
                "hmma_in_sass": hmma[tag]}
            if tag == "tree":
                cs.check(ok, f"{case}: disagrees with its twin "
                         f"({kernels[tag]['max_abs_err']})")
                cs.check(kernels[tag]["bitwise_repeat"],
                         f"{case}: not deterministic")
        info = {"plain_ms": plain_ms, "max_abs_ref": float(ref.abs().max()),
                "max_abs_ref_by_feature": ref.abs().amax(dim=[
                    d for d in range(ref.ndim) if d != feature_dim]).tolist()}
        del ref, tree, acc, again
        times = {tag: [] for tag in names}
        for _ in range(rounds):
            for tag in names + names[::-1]:
                times[tag].append(cs.time_ms(lambda: runs[tag](*kargs), 20))
        for tag in names:
            prof = cs.profile_calls(lambda i: runs[tag](*kargs), 20)
            kernels[tag].update(ms=statistics.median(times[tag]),
                                rounds_ms=times[tag],
                                device_ms=prof["device_busy_ms_per_call"])
            if split:
                parts = cs.device_split(prof, *split)
                kernels[tag].update(device_ms_main=parts["main"],
                                    device_ms_second=parts["second"])
        for _ in range(max(1, int(300 / max(kernels["tree"]["ms"], 1e-3)))):
            runs["tree"](*kargs)
        info["sm_clock_mhz"] = cs.sm_clock_mhz()
        torch.cuda.synchronize()
    return kernels, info

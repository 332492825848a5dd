"""Readings that the correctness limits are set from, on the card at a
cell's own size, in one process:

    python3 gsbench/calibrate.py --workload <cell> --seeds 1,2,3,... \
        [--control 3] [--faults 3] [--seconds 2] [--out FILE]

For every seed: the cell's set-up (its checked steps, or for serving a
window of --seconds at the cell's load), then each compared number of the
program against the plain reference. For the first --control seeds, the
control: the reference computed with TF32 products (the precision below
the configurations' float32 with TF32 off) in the program's place. For the
first --faults seeds, each fault of gsbench/faults.py planted in the
program (a training cell's faults; a state left unchanged reads 1 and is
not run). One JSON line a reading on standard output, and in --out.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from gsbench import faults, harness

    def log(msg):
        print(f"[calibrate] {msg}", file=sys.stderr, flush=True)

    cell = harness.find_cell(ROOT, args.workload)
    kind_name = cell["traffic"]["kind"]
    kind = harness.traffic_kind(ROOT, kind_name)
    device = torch.device("cuda", 0)
    tmp = Path(tempfile.gettempdir())
    out = open(args.out, "w") if args.out else None

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def readings(checks):
        return {name: value for name, value, _ in checks}

    def program(seed):
        run = kind.Run(cell, seed, device, tmp, log)
        if kind_name == "serve":
            run.window(args.seconds)
        run.release()
        return run

    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run = program(seed)
        t1 = time.perf_counter()
        ref = run.reference_outputs()
        t2 = time.perf_counter()
        extra = {}
        if kind_name == "fit":
            extra["step_loss_gaps"] = kind.step_loss_gaps(run.outputs(), ref)
        emit(workload=args.workload, seed=seed, side="program",
             readings=readings(run.compare(run.outputs(), ref)),
             setup_s=t1 - t0, reference_s=t2 - t1, **extra)
        if i < args.control:
            ctrl = run.reference_outputs(tf32=True)
            if kind_name == "fit":
                extra["step_loss_gaps"] = kind.step_loss_gaps(ctrl, ref)
            emit(workload=args.workload, seed=seed, side="control_tf32",
                 readings=readings(run.compare(ctrl, ref)), **extra)
        if i < args.faults:
            for fault in faults.KINDS[kind_name]:
                if fault == "unchanged":
                    continue
                with faults.planted(fault):
                    bad = program(seed)
                # A served fault is judged on its own window's frames.
                ref_f = ref if kind_name == "fit" else bad.reference_outputs()
                if kind_name == "fit":
                    extra["step_loss_gaps"] = kind.step_loss_gaps(
                        bad.outputs(), ref_f)
                emit(workload=args.workload, seed=seed, side=f"fault_{fault}",
                     readings=readings(bad.compare(bad.outputs(), ref_f)),
                     **extra)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

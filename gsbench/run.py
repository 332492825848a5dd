"""Run one benchmark cell once on the card and print its result line.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

--trace 0 measures the cell's end-to-end metrics over a window of
--seconds; --trace 1 traces short profiler windows instead and reports its
per-layer metrics. Both check the window's outputs against the plain
reference under gsbench/reference/ and print each compared number beside
its limit, last on standard error and last in the result line. The last
line of standard output is one JSON object. A run that finds fewer CUDA
cards than the cell asks for exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"[gsbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None, allow_cpu: bool = False, root: Path = ROOT) -> int:
    """Run a cell. allow_cpu (tests only) runs it on the CPU through the
    kernels' plain twins, a rehearsal whose numbers are not device
    metrics."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    import torch

    from gsbench import harness

    # One host thread for torch's CPU work: the load comes from this
    # process's dispatch alone.
    torch.set_num_threads(1)

    cell = harness.find_cell(root, args.workload)
    card = None
    if allow_cpu:
        device = torch.device("cpu")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            log(f"needs {cell['chips']} CUDA card(s), found {have}")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
        card = harness.power_limit()
        log(f"card: {card}")
    kind = harness.traffic_kind(root, cell["traffic"]["kind"])
    run = kind.Run(cell, args.seed, device, Path(tempfile.gettempdir()), log)
    setup_s = time.perf_counter() - T_START
    log(f"setup {setup_s:.3f} s")

    if args.trace:
        facts = run.traced()
    else:
        metrics = run.window(args.seconds)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        names = {m["name"] for m in cell["end_to_end"]}
        metrics = {k: v for k, v in metrics.items() if k in names}
    attempted, failed = run.attempted, run.failed
    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    run.release()
    if args.trace:
        # The work of the traced calls, counted by the reference once the
        # program's state is freed.
        run.count_work()
        metrics = harness.read_metrics(root, cell["per_layer"], facts)
    t_check = time.perf_counter()
    checks = run.check()
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)

    found = harness.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": mem_peak,
                         "power_limit": card}}
    if args.trace:
        result["device"]["busy_s"] = facts["a"]["busy_s"]
        result["device"]["window_s"] = facts["a"]["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in facts["a"]["top_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in facts["b"]["idle_gaps"][:10]]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for line in harness.checks_text(checks):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())

#!/usr/bin/env python3
"""Count the kernel events that a torch.profiler window keeps, over a
process's life, for two waits at the window's ends.

  python3 tpu_gaussians_torch/tools/profiler_window_probe.py \
      [--seconds 420] [--period 12] [--pads 0.2 2.0]

Every `period` seconds it opens one window (CPU and CUDA activities) that
sleeps `pad` seconds, launches a small elementwise kernel ten times with a
synchronize after each, sleeps `pad` seconds again and exports a Chrome
trace; the pads are taken in turn. Per window it prints one JSON line: the
seconds since the start, the pad, the kernel events kept, the launches the
trace holds, and the median of kernel start minus launch (by correlation
id, microseconds) over the kernels kept. chip_smoke's launched_blocks
reads a kernel's grid from such a window and needs at least one event.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path


def window(x, pad: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(10):
                x.add_(1.0)
                torch.cuda.synchronize()
            time.sleep(pad)
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"].get("correlation"): e for e in events
                if e.get("cat") == "cuda_runtime"
                and "aunch" in e.get("name", "")}
    offsets = sorted(e["ts"] - launches[e["args"]["correlation"]]["ts"]
                     for e in kernels
                     if e["args"].get("correlation") in launches)
    return {"kernels": len(kernels), "launches": len(launches),
            "median_offset_us": (offsets[len(offsets) // 2] if offsets
                                 else None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seconds", type=float, default=420.0)
    ap.add_argument("--period", type=float, default=12.0)
    ap.add_argument("--pads", type=float, nargs="+", default=[0.2, 2.0])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profiler_window_probe needs a CUDA device")
    x = torch.zeros(1 << 16, device="cuda")
    start = time.time()
    i = 0
    while time.time() - start < args.seconds:
        pad = args.pads[i % len(args.pads)]
        out = window(x, pad)
        print(json.dumps({"t_s": round(time.time() - start, 1),
                          "pad_s": pad, **out}), flush=True)
        i += 1
        time.sleep(args.period)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

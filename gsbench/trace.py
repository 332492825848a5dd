"""Profiler windows on the card and their reduction to what the per-layer
metric readers read.

A window is torch.profiler (CPU and CUDA activities) around `calls` calls
inside a "gsbench.window" range, with `pad_s` of host sleep at both ends:
a window on the H100 drops kernel events near its ends
(tpu_gaussians_torch/tools/profiler_window_probe.py). The chrome trace is
reduced to:
  window_s   the range's length (it ends in a synchronize)
  busy_s     the union of device intervals (kernels, copies, sets) in it
  host_ops   aten operations that no other aten operation encloses on
             their thread, as chip_smoke.profile_calls counts them, outside
             "gsbench.exclude" ranges
  device     per device operation: (name, seconds, the names of every
             range open on the launching thread at its launch: operators,
             autograd nodes, and with with_stack the Python frames)
  top_ops    device seconds by operation name, most first
  idle_gaps  idle seconds by the outermost operator that launched the work
             ending each gap, most first
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "gsbench.window"
# Work of the benchmark's own inside a window (snapshots for the counts):
# its operators are not counted among the program's host operations.
EXCLUDE = "gsbench.exclude"


def synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_window(run: Callable[[], int], with_stack: bool, pad_s: float,
                   tmpdir: Path, host: bool = True) -> dict:
    """Profile run() (which returns its number of calls) and reduce the
    trace. host=False records the card's activity alone: the host then
    runs at its own pace (recording its operators costs some 20 us each),
    and the window is the host clock's from the first call to the final
    synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    activities = activities or [ProfilerActivity.CPU]   # a CPU rehearsal
    synchronize()
    with profile(activities=activities, with_stack=with_stack) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        with record_function(WINDOW):
            calls = run()
            synchronize()
        wall = time.perf_counter() - t0
        time.sleep(pad_s)
    path = Path(tmpdir) / f"gsbench_trace_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    out = reduce_events(events, None if host else wall)
    out["calls"] = calls
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace or arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        if stop in name[1:]:
            name = name[0] + name[1:].split(stop, 1)[0]
    return name[:80]


def reduce_events(events: List[dict], wall_s=None) -> dict:
    """Reduce a chrome trace. With wall_s (a trace of the card alone) the
    window is wall_s long and holds every device event of the trace."""
    xs = [e for e in events if e.get("ph") == "X"]
    if wall_s is None:
        win = [e for e in xs if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no gsbench.window range")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        w0 = min((e["ts"] for e in dev), default=0.0)
        w1 = max((e["ts"] + e["dur"] for e in dev), default=0.0)

    launches = {}
    by_tid: Dict[object, List[Tuple[float, int, dict]]] = defaultdict(list)
    for e in xs:
        cat = e.get("cat")
        if cat in RANGE_CATS:
            by_tid[e["tid"]].append((e["ts"], 0, e))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_tid[e["tid"]].append((e["ts"], 1, e))

    host_ops = 0
    for tid, items in by_tid.items():
        items.sort(key=lambda it: (it[0], it[1], -it[2].get("dur", 0)))
        stack: List[dict] = []
        for ts, kind, e in items:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ts:
                stack.pop()
            if kind == 1:
                # Threads started inside a window record no operators:
                # their launches are named by the runtime call.
                outer = next((s["name"] for s in stack
                              if s.get("cat") == "cpu_op"), e["name"])
                launches[e["args"]["correlation"]] = (
                    tuple(s["name"] for s in stack), outer)
                continue
            if (e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
                    and w0 <= ts <= w1
                    and not any((s.get("cat") == "cpu_op"
                                 and s["name"].startswith("aten::"))
                                or s["name"] == EXCLUDE for s in stack)):
                host_ops += 1
            stack.append(e)

    device = []
    intervals = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s0, s1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if s1 <= s0:
            continue
        names, outer = launches.get(e.get("args", {}).get("correlation"),
                                    ((), "(no launch found)"))
        device.append((e["name"], (s1 - s0) * 1e-6, names))
        intervals.append((s0, s1, outer))

    intervals.sort()
    busy, gaps = 0.0, defaultdict(float)
    cur0 = cur1 = None
    last_end = w0
    for s0, s1, outer in intervals:
        if cur1 is None or s0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if s0 > last_end:
                gaps[outer[:80]] += (s0 - last_end) * 1e-6
            cur0, cur1 = s0, s1
        else:
            cur1 = max(cur1, s1)
        last_end = cur1
    if cur1 is not None:
        busy += cur1 - cur0
        if w1 > cur1:
            gaps["(window end: the final synchronize)"] += (w1 - cur1) * 1e-6

    top = defaultdict(float)
    for name, sec, _ in device:
        top[_short(name)] += sec
    return {
        "window_s": (w1 - w0) * 1e-6 if wall_s is None else wall_s,
        "busy_s": busy * 1e-6,
        "host_ops": host_ops,
        "device": device,
        "top_ops": sorted(top.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
    }


def device_seconds(trace: dict, patterns: Tuple[str, ...],
                   exclude: Tuple[str, ...] = ()) -> float:
    """Device seconds of the operations whose launch lay inside a range
    whose name holds one of `patterns` and none of `exclude`."""
    total = 0.0
    for _, sec, names in trace["device"]:
        if any(x in n for n in names for x in exclude):
            continue
        if any(p in n for n in names for p in patterns):
            total += sec
    return total

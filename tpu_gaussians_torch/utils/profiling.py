"""Profiling and observability hooks on torch.profiler, the counterparts of
`tpu_gaussians.utils.profiling` (the reference has only a hand-rolled FPS
EMA, model_viewer_main.cpp:243-251):

- `trace(logdir)`: context manager around torch.profiler that writes a
  Chrome trace (`trace-<ns>.json`, chrome://tracing or Perfetto) of the
  work inside; it records the card's kernels when CUDA is available.
- `annotate(name)`: a named region in such a trace (record_function).
- `load_trace_events(logdir)` / `device_program_times_us(fn, prefix)`:
  the device kernel events of the newest trace, and their durations.
  A trace with no device track (a CPU run) gives [], never host events
  under a device name.
- `StepTimer`: EMA wall-clock per-step timer + pixels/s counter.
- `launch_counts()`: every kernel wrapper's launches in this process.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

# torch.profiler's Chrome-trace categories of work that ran on the card.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            str(Path(logdir) / f"trace-{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def load_trace_events(logdir: str):
    """The complete ('X') events of the device's work in the newest
    trace-*.json under logdir; [] when it has none (a CPU run), so that a
    caller falls back to its wall clock explicitly instead of taking host
    durations for device time."""
    paths = sorted(Path(logdir).glob("**/trace-*.json"))
    if not paths:
        raise FileNotFoundError(f"no trace-*.json under {logdir}")
    events = json.loads(paths[-1].read_text()).get("traceEvents", [])
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def device_program_times_us(fn, prefix: str = ""):
    """Run `fn()` under the profiler and return the device durations
    (microseconds) of every device event whose name starts with `prefix`
    (a kernel's name, e.g. "splat_sep_fwd_kernel"; "" = every one), in
    trace order. Device time is immune to the host's dispatch latency and
    hiccups that a wall clock sees."""
    import shutil
    import tempfile

    logdir = tempfile.mkdtemp(prefix="tpugs_devtime_")
    try:
        with trace(logdir):
            fn()
        durs = [(e.get("ts", 0), float(e.get("dur", 0.0)))
                for e in load_trace_events(logdir)
                if e.get("name", "").startswith(prefix)]
        durs.sort()
        return [d for _, d in durs]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


class StepTimer:
    """EMA-smoothed step timing (same smoothing constants as the reference
    viewer HUD: 0.8 old / 0.2 new)."""

    def __init__(self, pixels_per_step: int = 0, ema: float = 0.8):
        self.pixels_per_step = pixels_per_step
        self.ema = ema
        self._last: Optional[float] = None
        self.step_s: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_s = (dt if self.step_s is None
                           else self.ema * self.step_s + (1 - self.ema) * dt)
        self._last = now
        return self.step_s

    @property
    def pixels_per_s(self) -> Optional[float]:
        if self.step_s is None or self.pixels_per_step == 0:
            return None
        return self.pixels_per_step / self.step_s


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by kernel."""
    from tpu_gaussians_torch.kernels import (
        binned, sorted_bwd, sorted_fwd, splat_sep, splat_v1, splat_v2)

    return {"sorted_fwd": sorted_fwd.launches,
            "sorted_bwd": sorted_bwd.launches, **splat_sep.launches,
            **splat_v2.launches, **binned.launches, **splat_v1.launches}

"""Profiling and observability hooks on torch.profiler, the counterparts of
`tpu_gaussians.utils.profiling` (the reference has only a hand-rolled FPS
EMA, model_viewer_main.cpp:243-251):

- `trace(logdir)`: context manager around torch.profiler that writes a
  Chrome trace (`trace-<ns>.json`, chrome://tracing or Perfetto) of the
  work inside; it records the card's kernels when CUDA is available.
- `annotate(name, root=False)`: a span, the program's one tracing
  facility, placed at its layer boundaries (`gs.fit.step`,
  `gs.serve.frame`, `gs.stage`, `gs.binner`, ...). When no profiler runs
  (`torch.autograd.profiler._is_profiler_enabled`, a module flag that
  every torch.profiler session sets whatever its activities) it returns
  one shared no-op context manager: no `record_function`, no clock read,
  nothing recorded. While a profiler runs, the span
  - opens `record_function(name)`, so a trace with CPU activity holds it
    as a range and correlates every kernel launched inside it to it (a
    profiler records ranges on the thread that started it and on the
    autograd engine's threads, which inherit its state; the spans of
    other threads, such as a server's clients, are in the buffer alone);
  - appends a `Span` record to a bounded in-memory buffer when it closes:
    its name, thread, start and end by `time.time_ns()` read just outside
    the range's own (the clock of the Chrome trace's `ts` plus
    `baseTimeNanoseconds / 1000`), its own id, its parent (the innermost
    span open on the same thread when it opened) and its root's id.
  A root (`root=True`: a train step, a served frame) gives its own id to
  every span opened under it on its thread. A span opened on a thread with
  no open span of its own, such as the autograd engine's device threads
  (the card's backward; a CPU backward runs on the caller's thread), has
  no parent and no root: no reader needs one, as the engine's spans are
  read by range name in a trace. The trace needs no second writer:
  `trace()` exports the spans' ranges with everything else.
- `spans()`: the buffer's records, oldest first (at most `SPAN_BUFFER`;
  records are appended as spans close).
- `count(name, value)`: a counter, recorded on the terms of a span: the
  same no-op when no profiler runs (it returns at once, allocating
  nothing); while one runs, a `Count` record appended to a bounded buffer
  of its own: its name, thread, the value as given, and the id and root of
  the innermost span open on its thread. A device tensor stays on the
  device: recording it launches no kernel and waits for none; a reader
  takes `.item()` after its window. `counters()` reads the buffer, oldest
  first (at most `COUNT_BUFFER`). `active()` tells a caller whether a
  profiler runs, so that it makes a counter's value only then.
- `load_trace_events(logdir)` / `device_program_times_us(fn, prefix)`:
  the device kernel events of the newest trace, and their durations.
  A trace with no device track (a CPU run) gives [], never host events
  under a device name.
- `StepTimer`: EMA wall-clock per-step timer + pixels/s counter.
- `launch_counts()`: every kernel wrapper's launches in this process.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


class Span(NamedTuple):
    name: str
    thread: int                 # threading.get_ident() of the opening thread
    start_ns: int               # time.time_ns(), the trace's clock
    end_ns: int
    id: int
    parent: Optional[int]       # id of the enclosing span on the same thread
    root: Optional[int]         # id of the step or frame it belongs to


SPAN_BUFFER = 100_000
_spans: "collections.deque[Span]" = collections.deque(maxlen=SPAN_BUFFER)
_span_ids = itertools.count(1)
_open = threading.local()       # .stack: this thread's open _Span objects
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "is_root", "rf", "t0", "id", "parent", "root")

    def __init__(self, name: str, is_root: bool):
        self.name, self.is_root = name, is_root

    def __enter__(self) -> "_Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_span_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent = self.root = None
        if self.is_root:
            self.root = self.id
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.rf.__exit__(*exc)
        t1 = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, threading.get_ident(), self.t0, t1,
                           self.id, self.parent, self.root))


def active() -> bool:
    """Whether a profiler runs: the flag `annotate` and `count` test."""
    return _autograd_profiler._is_profiler_enabled


def annotate(name: str, root: bool = False):
    """A span named `name` (see the module docstring): the shared no-op
    unless a profiler runs. root: a step or frame, whose id the spans
    under it carry."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, root)


def spans() -> List[Span]:
    """Every span recorded while a profiler ran, oldest close first."""
    return list(_spans)


class Count(NamedTuple):
    name: str
    thread: int                 # threading.get_ident() of the recording thread
    value: object               # as given (a tensor stays where it was)
    span: Optional[int]         # id of the innermost span open on the thread
    root: Optional[int]         # that span's root


COUNT_BUFFER = 100_000
_counts: "collections.deque[Count]" = collections.deque(maxlen=COUNT_BUFFER)


def count(name: str, value) -> None:
    """Record `value` under `name` (see the module docstring): nothing
    unless a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_open, "stack", None)
    top = stack[-1] if stack else None
    _counts.append(Count(name, threading.get_ident(), value,
                         top.id if top is not None else None,
                         top.root if top is not None else None))


def counters() -> List[Count]:
    """Every counter recorded while a profiler ran, oldest first."""
    return list(_counts)


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
        binned, sorted_bwd, sorted_fwd, splat_sep, splat_v1, splat_v2, stage)

    return {"sorted_fwd": sorted_fwd.launches,
            "sorted_bwd": sorted_bwd.launches, **splat_sep.launches,
            **splat_v2.launches, **binned.launches, **splat_v1.launches,
            **stage.launches}

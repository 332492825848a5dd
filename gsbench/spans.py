"""The program's spans (`tpu_gaussians_torch.utils.profiling.annotate`), as
the span-based per-layer metrics read them.

A root span is a train step (`gs.fit.step`) or a served frame
(`gs.serve.frame`); every span opened under it on its thread carries its
id (the autograd engine's device threads' spans carry none, and are read
by range name alone). The program records spans
only while a profiler runs, so a traced run's buffer (`profiling.spans()`)
ends with window (a)'s roots and then window (b)'s: nothing is profiled
after the windows. It may hold earlier records (an earlier run's in the
same process), so a window's roots are counted back from the end: the
last facts["b"]["calls"] roots are window (b)'s, the facts["a"]["calls"]
before them window (a)'s. A buffer with fewer roots, or a program without
spans (before they were added), gives None.

Window (a) records the card alone and the host runs at its own pace: its
spans give host time. Window (b) records host operators: the device time
of the operations launched inside a span is read from its trace by range
name (`trace.device_seconds`).
"""

from __future__ import annotations

from typing import List, Optional

from gsbench.trace import device_seconds

ROOTS = {"fit": "gs.fit.step", "serve": "gs.serve.frame"}


def window_a_records(facts: dict) -> Optional[List]:
    """The span records under window (a)'s roots, the roots included, or
    None."""
    root_name = ROOTS.get(facts.get("kind"))
    if root_name is None or "a" not in facts or "b" not in facts:
        return None
    try:
        from tpu_gaussians_torch.utils import profiling
        records = profiling.spans()
    except (ImportError, AttributeError):
        return None
    n_a, n_b = facts["a"]["calls"], facts["b"]["calls"]
    roots = [r for r in records if r.root == r.id and r.name == root_name]
    if n_a <= 0 or len(roots) < n_a + n_b:
        return None
    end = len(roots) - n_b
    ids = {r.id for r in roots[end - n_a:end]}
    return [r for r in records if r.root in ids]


def host_ms(facts: dict, name: str) -> Optional[float]:
    """Host ms of the spans named `name` in window (a), a root (a step or
    a frame) on average; None where the window holds none."""
    records = window_a_records(facts)
    if records is None:
        return None
    durations = [r.end_ns - r.start_ns for r in records if r.name == name]
    if not durations:
        return None
    return sum(durations) / facts["a"]["calls"] / 1e6


def device_ms(facts: dict, kind: str, span: str, also=()) -> Optional[float]:
    """Device ms a call in window (b) of the operations launched inside the
    range `span`, and inside a range whose name holds one of `also`; None
    off `kind`'s cells or where nothing ran inside `span` (a program
    without the span)."""
    if facts.get("kind") != kind or not facts["b"]["calls"]:
        return None
    if device_seconds(facts["b"], (span,)) <= 0:
        return None
    sec = device_seconds(facts["b"], (span,) + tuple(also))
    return 1e3 * sec / facts["b"]["calls"]


def roofline(facts: dict, kind: str, work: str, span: str) -> Optional[float]:
    """The least time the chip could take for window (b)'s counted `work`
    over the device time launched inside `span`, in %."""
    if facts.get("kind") != kind or "work_b" not in facts:
        return None
    sec = device_seconds(facts["b"], (span,))
    if sec <= 0:
        return None
    return 100.0 * facts["work_b"][work].bound_s() / sec

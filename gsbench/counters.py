"""The program's counters (`tpu_gaussians_torch.utils.profiling.count`), as
the counter-based per-layer metrics read them.

A counter record carries the id of the innermost span open on its thread
when it was recorded and that span's root (a train step or a served
frame). Like spans, counters are recorded only while a profiler runs, so a
traced run's buffer (`profiling.counters()`) holds windows (a) and (b)'s.
Window (a)'s roots are found as `gsbench.spans.window_a_records` finds
them; a counter is window (a)'s when its root is one of them. A value may
be a device tensor, read here once the windows have closed. A program
without counters (before they were added), or a window short of roots,
gives None.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from gsbench.spans import window_a_records


def window_a_sums(facts: dict, names: Sequence[str]
                  ) -> Optional[Dict[str, float]]:
    """Each counter of `names` summed over window (a)'s roots; None where
    one of them was never recorded there."""
    records = window_a_records(facts)
    if records is None:
        return None
    try:
        from tpu_gaussians_torch.utils import profiling
        counts = profiling.counters()
    except (ImportError, AttributeError):
        return None
    roots = {r.root for r in records}
    sums = dict.fromkeys(names, 0.0)
    seen = set()
    for c in counts:
        if c.name in sums and c.root in roots:
            sums[c.name] += float(c.value)
            seen.add(c.name)
    return sums if seen == set(names) else None

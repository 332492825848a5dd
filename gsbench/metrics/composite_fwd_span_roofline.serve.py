"""composite_fwd_span_roofline.serve: the least time the chip could take for
the forward compositing the window's frames need (gsbench/counts.py:
composite_fwd, pairs counted by the reference) over the device time of the
operations launched inside the span `gs.composite.fwd` (K3, in
_SortedCore.forward), in window (b), in %: the span-based twin of
composite_fwd_roofline.serve. Layer: compositing kernels; moves serve_fps."""

from gsbench.spans import roofline

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "serve_fps"


def read(facts):
    return roofline(facts, "serve", "composite_fwd", "gs.composite.fwd")

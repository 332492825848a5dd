"""composite_fwd_span_roofline.fit: the least time the chip could take for
the forward compositing the window's steps need (gsbench/counts.py:
composite_fwd, pairs counted by the reference) over the device time of the
operations launched inside the span `gs.composite.fwd` (K3, in
_SortedCore.forward), in window (b), in %: the span-based twin of
composite_fwd_roofline.fit. Layer: compositing kernels; moves fit_mpix_s."""

from gsbench.spans import roofline

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "fit_mpix_s"


def read(facts):
    return roofline(facts, "fit", "composite_fwd", "gs.composite.fwd")

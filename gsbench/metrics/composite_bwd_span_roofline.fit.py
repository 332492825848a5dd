"""composite_bwd_span_roofline.fit: the least time the chip could take for
the backward compositing the window's steps need (gsbench/counts.py:
composite_bwd) over the device time of the operations launched inside the
span `gs.composite.bwd` (K4 and ops/sorted.moment_postpass, in
_SortedCore.backward), in window (b), in %: the span-based twin of
composite_bwd_roofline.fit. Layer: compositing kernels; moves
fit_mpix_s."""

from gsbench.spans import roofline

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "fit_mpix_s"


def read(facts):
    return roofline(facts, "fit", "composite_bwd", "gs.composite.bwd")

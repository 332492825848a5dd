"""stage_bwd_ms.fit: device ms a step of the operations launched inside
the span `gs.stage.bwd` (kernels/stage.py, the stage's autograd backward:
one kernel a view), in window (b): the stage's backward. A program
without the span (before the stage was one autograd function) gives None.
Layer: per-gaussian stage; moves fit_mpix_s."""

from gsbench.spans import device_ms

UNIT = "ms/step"
LAYER = "per-gaussian stage"
MOVES = "fit_mpix_s"


def read(facts):
    return device_ms(facts, "fit", "gs.stage.bwd")

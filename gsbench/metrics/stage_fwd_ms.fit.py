"""stage_fwd_ms.fit: device ms a step of the operations launched inside
the span `gs.stage` (ops/common.py:prepare_splats), in window (b): the
stage's forward only. Its backward runs as the autograd engine's nodes of
the stage's operators, which no span encloses without wrapping the stage
in an autograd function of its own. Layer: per-gaussian stage; moves
fit_mpix_s."""

from gsbench.spans import device_ms

UNIT = "ms/step"
LAYER = "per-gaussian stage"
MOVES = "fit_mpix_s"


def read(facts):
    return device_ms(facts, "fit", "gs.stage")

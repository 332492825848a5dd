"""stage_ms.serve: device ms a frame of the operations launched inside the
span `gs.stage` (ops/common.py:prepare_splats: projection, footprint
conic, colours, masking over every gaussian), in window (b). Layer:
per-gaussian stage; moves serve_fps."""

from gsbench.spans import device_ms

UNIT = "ms/frame"
LAYER = "per-gaussian stage"
MOVES = "serve_fps"


def read(facts):
    return device_ms(facts, "serve", "gs.stage")

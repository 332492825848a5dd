"""binner_span_ms.serve: device ms a frame of the operations launched inside
the span `gs.binner` (ops/sorted.py:tile_lists: bin_pairs_2d, pack_gdata,
the slot gather) and inside the gather's backward node
(IndexSelectBackward0, the slot -> gaussian index_add_), in window (b):
the span-based twin of binner_ms.serve. Layer: binner; moves serve_fps."""

from gsbench.spans import device_ms

UNIT = "ms/frame"
LAYER = "binner"
MOVES = "serve_fps"
BACKWARD = ("evaluate_function: IndexSelectBackward0",)


def read(facts):
    return device_ms(facts, "serve", "gs.binner", BACKWARD)

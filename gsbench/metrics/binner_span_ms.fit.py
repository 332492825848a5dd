"""binner_span_ms.fit: device ms a step of the operations launched inside
the span `gs.binner` (ops/sorted.py:tile_lists: bin_pairs_2d, pack_gdata,
the slot gather) and inside the gather's backward node
(IndexSelectBackward0, the slot -> gaussian index_add_), in window (b):
the span-based twin of binner_ms.fit. Layer: binner; moves fit_mpix_s."""

from gsbench.spans import device_ms

UNIT = "ms/step"
LAYER = "binner"
MOVES = "fit_mpix_s"
BACKWARD = ("evaluate_function: IndexSelectBackward0",)


def read(facts):
    return device_ms(facts, "fit", "gs.binner", BACKWARD)

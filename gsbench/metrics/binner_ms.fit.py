"""binner_ms.fit: device ms a step of the binner: the operations launched
inside ops/binning.py, inside ops/sorted.py's tile_lists (the lists and the
slot gather) and inside the gather's backward (IndexSelectBackward0, the
slot -> gaussian index_add_), by launch correlation in window (b), which
records Python frames. Layer: binner; moves fit_mpix_s."""

from gsbench.trace import device_seconds

UNIT = "ms/step"
LAYER = "binner"
MOVES = "fit_mpix_s"
PATTERNS = ("ops/binning.py(", "): tile_lists",
            "evaluate_function: IndexSelectBackward0")


def read(facts):
    if facts.get("kind") != "fit" or not facts["b"]["calls"]:
        return None
    sec = device_seconds(facts["b"], PATTERNS)
    return 1e3 * sec / facts["b"]["calls"] if sec > 0 else None

"""serve_mfu: the least time the chip could take for the window's frames
(gsbench/counts.py: serve_frame, itemised there) over the
window, in %, in window (a). Layer: whole frame; moves serve_fps."""

UNIT = "%"
LAYER = "whole frame"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve" or "work_a" not in facts:
        return None
    return 100.0 * facts["work_a"]["frame"].bound_s() / facts["a"]["window_s"]

"""fit_mfu: the least time the chip could take for the window's steps
(gsbench/counts.py: train_step, itemised there) over the
window, in %, in window (a). Layer: whole step; moves fit_mpix_s."""

UNIT = "%"
LAYER = "whole step"
MOVES = "fit_mpix_s"


def read(facts):
    if facts.get("kind") != "fit" or "work_a" not in facts:
        return None
    return 100.0 * facts["work_a"]["step"].bound_s() / facts["a"]["window_s"]

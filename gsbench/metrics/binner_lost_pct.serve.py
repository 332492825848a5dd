"""binner_lost_pct.serve: the share of the true (gaussian, tile) overlaps
that the binner lost in window (a), in %: those past the per-gaussian tile
budget (gs.binner.clipped) and past the tile capacity (gs.binner.dropped)
over every overlap (gs.binner.pairs, within the budget, plus the clipped).
A lost overlap is a frame drawn short of the exact one. Layer: binner;
moves serve_fps."""

from gsbench.counters import window_a_sums

UNIT = "%"
LAYER = "binner"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve":
        return None
    sums = window_a_sums(facts, ("gs.binner.pairs", "gs.binner.dropped",
                                 "gs.binner.clipped"))
    if sums is None:
        return None
    overlaps = sums["gs.binner.pairs"] + sums["gs.binner.clipped"]
    if overlaps <= 0:
        return None
    lost = sums["gs.binner.clipped"] + sums["gs.binner.dropped"]
    return 100.0 * lost / overlaps

"""binner_pairs_m.serve: millions of (gaussian, tile) pairs the binner
lists a frame (ops/sorted.py:tile_lists: the overlaps within the
per-gaussian tile budget less those dropped by the tile capacity, the
counters gs.binner.pairs - gs.binner.dropped), over window (a)'s frames,
the cell's clients at their own pace. The pairs are what the pair sort,
the slot gather and K3 work through. Layer: binner; moves serve_fps."""

from gsbench.counters import window_a_sums

UNIT = "Mpairs/frame"
LAYER = "binner"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve":
        return None
    sums = window_a_sums(facts, ("gs.binner.pairs", "gs.binner.dropped"))
    if sums is None:
        return None
    listed = sums["gs.binner.pairs"] - sums["gs.binner.dropped"]
    return listed / facts["a"]["calls"] / 1e6

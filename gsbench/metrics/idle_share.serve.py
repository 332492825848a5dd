"""idle_share.serve: the share of window (a) in which no operation ran on
the card: 1 - the union of device intervals over the window, in %.
Layer: device; moves serve_fps."""

UNIT = "%"
LAYER = "device"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve" or facts["a"]["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - facts["a"]["busy_s"] / facts["a"]["window_s"])

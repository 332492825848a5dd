"""idle_share.fit: the share of window (a) in which no operation ran on
the card: 1 - the union of device intervals over the window, in %.
Layer: device; moves fit_mpix_s."""

UNIT = "%"
LAYER = "device"
MOVES = "fit_mpix_s"


def read(facts):
    if facts.get("kind") != "fit" or facts["a"]["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - facts["a"]["busy_s"] / facts["a"]["window_s"])

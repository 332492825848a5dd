"""host_step_ms.fit: host ms a step inside the span `gs.fit.step` (the
whole train step: forward dispatch, backward, Adam), in window (a), where
only the card is recorded and the host runs at its own pace. Set beside
window (a)'s device busy ms a step, it says whether the host paces the
card. Layer: train step; moves fit_mpix_s."""

from gsbench.spans import host_ms

UNIT = "ms/step"
LAYER = "train step"
MOVES = "fit_mpix_s"


def read(facts):
    if facts.get("kind") != "fit":
        return None
    return host_ms(facts, "gs.fit.step")

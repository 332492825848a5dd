"""host_bwd_ms.fit: host ms a step inside the span `gs.fit.backward`
(`loss.backward()`: the autograd engine's dispatch of the backward, whose
nodes head the traced breakdown's idle gaps), in window (a), the host at
its own pace. Layer: train step; moves fit_mpix_s."""

from gsbench.spans import host_ms

UNIT = "ms/step"
LAYER = "train step"
MOVES = "fit_mpix_s"


def read(facts):
    if facts.get("kind") != "fit":
        return None
    return host_ms(facts, "gs.fit.backward")

"""host_ops.fit: the aten operations the host dispatches a step, those
that no other aten operation encloses on their thread, in window (b),
the one that records host operators (chip_smoke.profile_calls' count).
Layer: train step; moves fit_mpix_s."""

UNIT = "ops/step"
LAYER = "train step"
MOVES = "fit_mpix_s"


def read(facts):
    if facts.get("kind") != "fit" or not facts["b"]["calls"]:
        return None
    return facts["b"]["host_ops"] / facts["b"]["calls"]

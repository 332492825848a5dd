"""serve_frame_ms_p95: the 95th percentile, over every frame of the traced
run's untraced closed-loop window (`tail_seconds` of the mix, the cell's
clients at their own pace), of the host-clock time from a client's request
to its frame as a host array. The closed loop keeps the service saturated,
so its clients queue on the service's lock and the tail follows the order
in which the lock wakes them. Layer: viewer service; moves serve_fps."""

UNIT = "ms"
LAYER = "viewer service"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve":
        return None
    return facts.get("frame_ms_p95")

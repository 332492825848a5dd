"""lock_wait_ms.serve: host ms a frame inside the span
`gs.serve.lock_wait`, a request's wait for `RenderService`'s lock, over
window (a)'s frames from the cell's closed-loop clients: the queue.
Layer: viewer service; moves serve_fps."""

from gsbench.spans import host_ms

UNIT = "ms/frame"
LAYER = "viewer service"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve":
        return None
    return host_ms(facts, "gs.serve.lock_wait")

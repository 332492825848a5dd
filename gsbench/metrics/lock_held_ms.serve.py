"""lock_held_ms.serve: host ms a frame inside the span `gs.serve.render`,
the section `RenderService`'s lock serialises (camera, render, quantise),
in window (a), the cell's clients at their own pace. The window's
profiler (CUDA activity) and the spans it turns on slow that section, so
the reading is the traced service's, above an untraced frame's. Layer:
viewer service; moves serve_fps."""

from gsbench.spans import host_ms

UNIT = "ms/frame"
LAYER = "viewer service"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve":
        return None
    return host_ms(facts, "gs.serve.render")

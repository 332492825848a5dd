"""host_ops.serve: the aten operations the host dispatches a frame, those
that no other aten operation encloses on their thread, in window (b),
where the frames are rendered one after another by the profiling thread
(torch.profiler records no operators of threads started inside a window)
(chip_smoke.profile_calls' count). Layer: viewer service; moves serve_fps."""

UNIT = "ops/frame"
LAYER = "viewer service"
MOVES = "serve_fps"


def read(facts):
    if facts.get("kind") != "serve" or not facts["b"]["calls"]:
        return None
    return facts["b"]["host_ops"] / facts["b"]["calls"]

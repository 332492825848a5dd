"""composite_fwd_roofline.serve: the least time the chip could take for the
forward compositing the window's frames need (gsbench/counts.py:
composite_fwd, pairs counted by the reference) over the device time of the
operations launched from kernels/sorted_fwd.py (K3), in window (b), in %.
Layer: compositing kernels; moves serve_fps."""

from gsbench.trace import device_seconds

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "serve_fps"
PATTERNS = ("kernels/sorted_fwd.py(",)


def read(facts):
    if facts.get("kind") != "serve" or "work_b" not in facts:
        return None
    sec = device_seconds(facts["b"], PATTERNS)
    if sec <= 0:
        return None
    return 100.0 * facts["work_b"]["composite_fwd"].bound_s() / sec

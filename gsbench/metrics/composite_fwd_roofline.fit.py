"""composite_fwd_roofline.fit: the least time the chip could take for the
forward compositing the window's steps need (gsbench/counts.py:
composite_fwd, pairs counted by the reference) over the device time of the
operations launched from kernels/sorted_fwd.py (K3), in window (b), in %.
Layer: compositing kernels; moves fit_mpix_s."""

from gsbench.trace import device_seconds

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "fit_mpix_s"
PATTERNS = ("kernels/sorted_fwd.py(",)


def read(facts):
    if facts.get("kind") != "fit" or "work_b" not in facts:
        return None
    sec = device_seconds(facts["b"], PATTERNS)
    if sec <= 0:
        return None
    return 100.0 * facts["work_b"]["composite_fwd"].bound_s() / sec

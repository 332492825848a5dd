"""composite_bwd_roofline.fit: the least time the chip could take for the
backward compositing the window's steps need (gsbench/counts.py:
composite_bwd) over the device time of the operations of the compositing's
autograd node (_SortedCoreBackward: K4, launched from kernels/sorted_bwd.py,
and its post-pass ops/sorted.moment_postpass), in window (b), in %.
Layer: compositing kernels; moves fit_mpix_s."""

from gsbench.trace import device_seconds

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "fit_mpix_s"
PATTERNS = ("evaluate_function: _SortedCoreBackward",
            "kernels/sorted_bwd.py(", "): moment_postpass")


def read(facts):
    if facts.get("kind") != "fit" or "work_b" not in facts:
        return None
    sec = device_seconds(facts["b"], PATTERNS)
    if sec <= 0:
        return None
    return 100.0 * facts["work_b"]["composite_bwd"].bound_s() / sec

"""composite_bwd_walked_pct.fit: the share of K4's (slot, block, warp)
walks that its culling keeps, in %: 100 x walked / unculled, summed over
every record of gs.composite.bwd.walks in the buffer (an int64 pair:
the walks the warps' lists held, the unculled kernel's, composited slots
x 32), windows (a) and (b) alike: a share needs no window, and K4 runs
on the autograd engine's device thread, where a counter has no root.
A program without the counter gives None. Layer: compositing kernels;
moves fit_mpix_s."""

UNIT = "%"
LAYER = "compositing kernels"
MOVES = "fit_mpix_s"
NAME = "gs.composite.bwd.walks"


def read(facts):
    if facts.get("kind") != "fit":
        return None
    try:
        from tpu_gaussians_torch.utils import profiling
        counts = profiling.counters()
    except (ImportError, AttributeError):
        return None
    walked = unculled = 0
    for c in counts:
        if c.name == NAME:
            w, u = (int(v) for v in c.value.tolist())
            walked, unculled = walked + w, unculled + u
    if unculled <= 0:
        return None
    return 100.0 * walked / unculled

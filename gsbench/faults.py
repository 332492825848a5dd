"""Faults planted in the program under test, each of which the check must
catch (`correct` false): the tests drive a whole run with one planted, and
gsbench/calibrate.py reads each on the card at the cell's size.

  unchanged      (fit) the step returns its state unchanged: Adam's
                 update is skipped
  half_batch     (fit) the step renders half of its views and takes the
                 loss's mean over the rest
  altered_tile   (fit, serve) the compositing kernel's output is altered
                 where it is produced: the middle tile's colour + 0.05
  stale_frame    (serve) a request is answered with the frame of the
                 request before it
"""

from __future__ import annotations

import contextlib

KINDS = {"fit": ("unchanged", "half_batch", "altered_tile"),
         "serve": ("altered_tile", "stale_frame")}


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def planted(fault: str):
    """A context manager under which the program carries `fault`."""
    if fault == "unchanged":
        from tpu_gaussians_torch.fit import step

        return _patched(step, "adam_update", lambda state, scale=1.0: None)
    if fault == "half_batch":
        from tpu_gaussians_torch.fit import step

        inner = step.loss_fn

        def half(raw, cameras, targets, masks, depths, rc, lc):
            h = max(1, cameras.num_views() // 2)
            return inner(raw, cameras[:h], targets[:h],
                         None if masks is None else masks[:h],
                         None if depths is None else depths[:h], rc, lc)

        return _patched(step, "loss_fn", half)
    if fault == "altered_tile":
        from tpu_gaussians_torch.ops import sorted as ops_sorted

        inner = ops_sorted.sorted_tiles

        def altered(gdense, cnt, tiles_x, axis=False, exit_t=1e-6):
            acc, chunks = inner(gdense, cnt, tiles_x, axis=axis, exit_t=exit_t)
            tps = acc.shape[1] // cnt.shape[0]
            t = cnt.shape[0] // 2
            acc = acc.clone()
            acc[0:3, t * tps:(t + 1) * tps] += 0.05
            return acc, chunks

        return _patched(ops_sorted, "sorted_tiles", altered)
    if fault == "stale_frame":
        from tpu_gaussians_torch.cli import serve

        inner = serve.render
        last = []

        def stale(gaussians, camera, config, *a, **k):
            img = inner(gaussians, camera, config, *a, **k)
            last.append(img)
            return last[-2] if len(last) > 1 else img

        return _patched(serve, "render", stale)
    raise KeyError(f"no fault {fault!r}")

"""Public render entry point with implementation dispatch, as
`tpu_gaussians.ops.dispatch`: RenderConfig.impl "tiled" (binner + per-tile
compositing kernel; "auto" picks it) or "torch" (the whole-frame plain
renderer, exact). The two agree to float tolerance.

Only the depth-sorted mode is in this package so far; the accumulation
mode (the training path) comes with the training slice.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple, Union

import torch

from tpu_gaussians_torch.core.types import (
    Camera, Gaussians, RenderConfig, validate_camera, validate_gaussians)
from tpu_gaussians_torch.ops import plain_renderer
from tpu_gaussians_torch.ops import sorted as tiled_sorted
from tpu_gaussians_torch.ops.binning import EXIT_T
from tpu_gaussians_torch.ops.common import prepare_splats
from tpu_gaussians_torch.ops.projection import camera_z


def _resolve_impl(impl: str) -> str:
    return "tiled" if impl == "auto" else impl


_warned: set = set()


def _warn_ignored(knobs: str, path: str) -> None:
    """One-time warning when a path-specific RenderConfig knob is set on a
    path that ignores it, so that benchmarking a knob never silently
    measures the un-knobbed path."""
    msg = f"RenderConfig {knobs} ignored on the {path} path"
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg, stacklevel=3)


def zero_overflow_stats(device) -> Dict[str, torch.Tensor]:
    """The no-binner stats dict (the plain renderer is exact)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return {"dropped_pairs": zero, "full_tiles": zero,
            "clipped_rect_pairs": zero}


def render_accum(g: Gaussians, view: torch.Tensor, proj: torch.Tensor,
                 config: RenderConfig, row0=None, return_stats: bool = False):
    """Weighted-average mode: not in this package yet."""
    raise NotImplementedError(
        "mode='accum' (the weighted-average training path, kernels K1/K2) "
        "is ported in slice 2, the accumulation training slice; use "
        "mode='sorted'")


def render_sorted(
    g: Gaussians, view: torch.Tensor, proj: torch.Tensor,
    config: RenderConfig, row0: Union[torch.Tensor, float, None] = None,
    return_stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Depth-sorted front-to-back mode -> (image, alpha, depth)
    [+ binner overflow stats when return_stats].

    depth is the alpha-weighted expected camera depth. row0: render the
    row window [row0, row0 + config.height) of the full frame the camera
    was built for (config.proj_height); weights depend only on gy - py, so
    shifting py is exact.
    """
    s = prepare_splats(g, view, proj, config.width, config.full_height(),
                       footprint=config.footprint)
    if row0 is not None:
        s = s._replace(py=s.py - row0)
    z = camera_z(g.means, view)
    background = config.background_tensor(g.device)
    if _resolve_impl(config.impl) == "tiled":
        return tiled_sorted.sorted_composite(
            s, z, background, config.height, config.width,
            band_capacity=config.sorted_band_capacity,
            axis=(config.footprint == "axis"),
            return_stats=return_stats,
            exit_t=(config.sorted_exit_t if config.sorted_exit_t > 0
                    else EXIT_T),
            pair_k=config.sorted_pair_k,
        )
    if (config.sorted_pair_k or config.sorted_band_capacity
            or config.sorted_exit_t):
        _warn_ignored("sorted_pair_k/exit_t/band_capacity",
                      "torch sorted (exact)")
    out = plain_renderer.composite_sorted(
        s, z, background, config.height, config.width,
        chunk=min(config.chunk_size, 64))
    return out + (zero_overflow_stats(g.device),) if return_stats else out


def render(
    gaussians: Gaussians,
    camera: Camera,
    config: RenderConfig,
    validate: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Render a Gaussian set from one camera, or from each of a batched
    camera's views in turn.

    Returns image (H,W,3), or (image, alpha, depth) when config.return_aux.
    With a batched Camera (V,4,4) all outputs gain a leading V axis. Runs
    on the device the gaussians live on.
    """
    if validate:
        validate_gaussians(gaussians)
        validate_camera(camera)
    render_mode = render_sorted if config.mode == "sorted" else render_accum

    def render_one(view, proj):
        image, alpha, depth = render_mode(gaussians, view, proj, config)
        return (image, alpha, depth) if config.return_aux else image

    if not camera.batched:
        return render_one(camera.view, camera.proj)
    outs = [render_one(camera.view[i], camera.proj[i])
            for i in range(camera.num_views())]
    if config.return_aux:
        return tuple(torch.stack(o, dim=0) for o in zip(*outs))
    return torch.stack(outs, dim=0)

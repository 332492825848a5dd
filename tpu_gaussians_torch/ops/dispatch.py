"""Public render entry point with implementation dispatch, as
`tpu_gaussians.ops.dispatch`: RenderConfig.impl "tiled" (the kernels;
"auto" picks it) or "torch" (the whole-frame plain renderer, exact). The
two agree to float tolerance.

  accum  tiled: ops/splat.splat_accumulate, the axis footprint through the
         separable band kernels K1/K2, the EWA footprint through the
         general-conic band kernels K5/K6; or, under accum_binned "on" or
         EWA at n >= BINNED_MIN_N under "auto", ops/binned.
         splat_accumulate_binned through the tile-binned kernels, the
         separable K7a/K7b for the axis footprint (reached only under
         "on") and K8a/K8b for EWA; all differentiable. The dense EWA
         route takes K5/K6 up to JAX's v2 sizes and the tile-grid K9a/K9b
         above them (ops/splat._choose_v2). torch: plain_renderer.accumulate
  sorted tiled: binner + per-tile compositing kernels K3/K4
         (differentiable); torch: plain_renderer.composite_sorted
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple, Union

import torch

from tpu_gaussians_torch.core.types import (
    Camera, Gaussians, RenderConfig, validate_camera, validate_gaussians)
from tpu_gaussians_torch.ops import plain_renderer
from tpu_gaussians_torch.ops import sorted as tiled_sorted
from tpu_gaussians_torch.ops.binned import (  # noqa: F401 (BINNED_MIN_N)
    ALPHA_CUTOFF, BINNED_MIN_N, W_CULL, binned_min_n,
    splat_accumulate_binned)
from tpu_gaussians_torch.ops.binning import EXIT_T
from tpu_gaussians_torch.ops.common import prepare_splats, resolve_accum
from tpu_gaussians_torch.ops.projection import camera_z
from tpu_gaussians_torch.ops.splat import splat_accumulate


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


def uses_binned_accum(config: RenderConfig, n: int) -> bool:
    """Whether the accumulation of n gaussians takes the tile-binned kernels
    (dispatch.py:87-100): accum_binned 'on', or 'auto' at n >=
    binned_min_n: BINNED_MIN_N for EWA, never for the axis footprint, whose
    band kernels win at every n."""
    if config.accum_binned == "on":
        return True
    return (config.accum_binned == "auto"
            and n >= binned_min_n(config.footprint == "axis"))


def zero_overflow_stats(device) -> Dict[str, torch.Tensor]:
    """The no-binner stats dict (the plain renderer is exact)."""
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return {"dropped_pairs": zero, "full_tiles": zero,
            "clipped_rect_pairs": zero}


def render_accum(
    g: Gaussians, view: torch.Tensor, proj: torch.Tensor,
    config: RenderConfig, row0: Union[torch.Tensor, float, None] = None,
    return_stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Weighted-average mode -> (image, alpha, depth) [+ the binner's
    overflow stats, zeros on the exact dense and plain paths].
    Differentiable.

    row0: render the row window [row0, row0 + config.height) of the full
    frame the camera was built for (config.proj_height); see render_sorted.
    accum_cull and accum_tile_capacity act on the tile-binned path only.
    """
    s = prepare_splats(g, view, proj, config.width, config.full_height(),
                       footprint=config.footprint)
    if row0 is not None:
        s = s._replace(py=s.py - row0)
    stats = zero_overflow_stats(g.device)
    knobs = config.accum_cull != "exact" or config.accum_tile_capacity
    if _resolve_impl(config.impl) == "tiled":
        axis = config.footprint == "axis"
        if uses_binned_accum(config, s.px.shape[0]):
            acc, stats = splat_accumulate_binned(
                s, config.height, config.width, axis=axis, return_stats=True,
                tile_capacity=config.accum_tile_capacity,
                cutoff=ALPHA_CUTOFF if config.accum_cull == "alpha"
                else W_CULL)
        else:
            if knobs:
                _warn_ignored("accum_cull/accum_tile_capacity",
                              "dense tiled accum (accum_binned off, or auto "
                              "below binned_min_n)")
            acc = splat_accumulate(s, config.height, config.width, axis=axis)
    else:
        if knobs:
            _warn_ignored("accum_cull/accum_tile_capacity", "torch accum")
        acc = plain_renderer.accumulate(s, config.height, config.width,
                                        chunk=config.chunk_size)
    out = resolve_accum(acc, config.background_tensor(g.device),
                        config.height, config.width)
    return out + (stats,) if return_stats else out


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

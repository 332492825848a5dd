"""Tiled (row-band) single-frame rendering over devices, as
`tpu_gaussians.parallel.tiled`.

Every device holds the whole gaussian set and renders its own horizontal
band of the frame; the bands concatenate into the frame. No communication
is needed, so this runs in one process: `devices` may name one card more
than once (its bands then render in turn), or the CPU.

A band is ceil(H / n_bands) rows rounded up to whole tile rows (JAX takes
ceil(H / n_bands)): each tile of a band is then the frame's own tile, so
the binner's per-tile capacity drops the same pairs in a band as in the
frame, and the banded frame equals the whole one under overflow too (as
long as no gaussian is clipped to its pair budget). Bands past the frame's
last row render nothing.

A band is rendered as a ROW WINDOW: projection runs against the full
(H, W) viewport, then per-gaussian screen y is shifted by the band's first
row (weights depend only on gy - py, so the shift is exact) and the splat
stage evaluates just band_rows of pixels. Every quantity (projection,
sigma, validity, depth order) is the full-frame render's; only the pixel
subset differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from tpu_gaussians_torch.core.types import (
    Camera, Device, Gaussians, RenderConfig, resolve_device)
from tpu_gaussians_torch.ops.dispatch import render_accum, render_sorted
from tpu_gaussians_torch.parallel.mesh import band_rows


def band_devices(n_bands: int, device: Device = "cuda") -> list:
    """`n_bands` devices, round-robin over the visible cards (or the CPU
    when `device` is the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_bands
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_bands)]


def _indexed(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def render_tiled(
    gaussians: Gaussians,
    camera: Camera,
    config: RenderConfig,
    devices: Optional[Sequence[Device]] = None,
    n_devices: Optional[int] = None,
):
    """Render ONE frame as bands of band_rows(H, n_bands) rows, band i on
    devices[i].

    Returns the same structure as ops.dispatch.render (image or (image,
    alpha, depth) per config.return_aux) at full (H, W) resolution, on the
    gaussians' device. Default devices: `n_devices` bands (one a card,
    default all cards) round-robin over the cards on a CUDA scene, or on
    the CPU for a CPU scene.
    """
    if camera.batched:
        raise ValueError("render_tiled expects a single (unbatched) camera")
    home = _indexed(gaussians.device)
    if devices is None:
        n = n_devices or (torch.cuda.device_count() if home.type == "cuda"
                          else 1)
        devices = band_devices(n, home.type)
    devices = [_indexed(resolve_device(d)) for d in devices]
    rows = band_rows(config.height, len(devices))
    band_config = config.replace(height=rows,
                                 proj_height=config.full_height())
    render_band = render_sorted if config.mode == "sorted" else render_accum

    bands = []
    for i, dev in enumerate(devices[:-(-config.height // rows)]):
        g = gaussians if dev == home else gaussians.replace(**{
            f.name: getattr(gaussians, f.name).to(dev)
            for f in dataclasses.fields(gaussians)
            if getattr(gaussians, f.name) is not None})
        view, proj = camera.view.to(dev), camera.proj.to(dev)
        out = render_band(g, view, proj, band_config, row0=float(i * rows))
        bands.append(tuple(t.to(home) for t in out))
    image, alpha, depth = (torch.cat([b[j] for b in bands])[:config.height]
                           for j in range(3))
    return (image, alpha, depth) if config.return_aux else image

"""Gaussian npz import/export in the reference schema, as
`tpu_gaussians.io.npz` writes and reads it.

Export schema (fit_multiview_stub.py:339-354): float32 arrays `means` (N,3),
`scales` (N,3) activated, `colors` (N,3) activated (for SH models: the
clamped dc term), `opacities` (N,) activated, and optionally `sh_coeffs`
(N,K,3) and the extension key `quaternions` (N,4). Import tolerates `(N,)`
or `(N,1)` opacities (model_viewer_main.cpp:123-129). Only alive rows are
exported, so files stay loadable by the reference viewers.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from tpu_gaussians_torch.core.types import Device, Gaussians, make_gaussians
from tpu_gaussians_torch.models.gaussian_model import RawParams, activate
from tpu_gaussians_torch.ops.sh import SH_C0


def save_gaussians_npz(path: Union[str, Path], g: Gaussians) -> None:
    """Write activated Gaussians (alive rows only) in the reference schema."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    alive = host(g.alive_mask()) > 0.5
    arrays = {"means": host(g.means)[alive], "scales": host(g.scales)[alive],
              "opacities": host(g.opacities)[alive]}
    if g.use_sh:
        sh = host(g.sh)[alive]
        if sh.shape[1] > 4:  # 3DGS convention: dc color = 0.5 + C0*sh0
            dc_rgb = 0.5 + SH_C0 * sh[:, 0, :]
        else:  # reference convention: dc IS the color
            dc_rgb = sh[:, 0, :]
        arrays["colors"] = np.clip(dc_rgb, 0.0, 1.0).astype(np.float32)
        arrays["sh_coeffs"] = sh
    else:
        arrays["colors"] = host(g.colors)[alive]
    if g.quats is not None:
        q = host(g.quats)[alive]
        arrays["quaternions"] = q / (np.linalg.norm(q, axis=1, keepdims=True)
                                     + 1e-12)
    np.savez(Path(path), **arrays)


def save_raw_npz(path: Union[str, Path], raw: RawParams) -> None:
    """Write a RawParams model (activated, alive rows only)."""
    save_gaussians_npz(path, activate(raw))


def load_gaussians_npz(path: Union[str, Path],
                       device: Device = "cuda") -> Gaussians:
    """Load a reference-schema npz into activated Gaussians on `device`."""
    data = np.load(Path(path))
    for k in ("means", "scales", "colors", "opacities"):
        if k not in data:
            raise KeyError(f"gaussians npz missing required array {k!r}")
    opacities = np.asarray(data["opacities"], dtype=np.float32)
    if opacities.ndim == 2 and opacities.shape[1] == 1:
        opacities = opacities[:, 0]
    sh = data["sh_coeffs"] if "sh_coeffs" in data else None
    quats = data["quaternions"] if "quaternions" in data else None
    return make_gaussians(
        data["means"], data["scales"], opacities,
        colors=None if sh is not None else data["colors"],
        sh=sh, quats=quats, device=device)

"""Raw (pre-activation) Gaussian parameters at fixed capacity, as
`tpu_gaussians.models.gaussian_model`.

A fixed-capacity set with an alive mask (fit_multiview_stub.py:114-137
`_build_params` grows and shrinks its arrays instead), so densify/prune
never changes shapes and models move between the two packages unchanged.
Activations match the reference exactly:

  scales    = softplus(scales_raw) + 1e-3     (fit_multiview_stub.py:269)
  opacities = sigmoid(opacities_raw)          (:270)
  colors    = sigmoid(colors_raw)             (:275)
  sh        = sh_raw (used directly)          (:273)

Initial distributions (fit_multiview_stub.py:119-135), drawn from an
explicit torch.Generator:
  means ~ U(-0.6, 0.6), scales_raw = opacities_raw = -2.2,
  colors_raw ~ 0.1 U(0,1), sh_raw zeros with dc row 0.1 U(0,1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tpu_gaussians_torch.core.types import (
    Device, Gaussians, resolve_device, to_device)
from tpu_gaussians_torch.ops.sh import SH_C0, sh_bands

LEAVES = ("means", "scales_raw", "opacities_raw", "colors_raw", "sh_raw",
          "alive", "quats_raw")


@dataclass(frozen=True)
class RawParams:
    """Trainable leaves (all float32, capacity C rows; dead rows inert)."""

    means: torch.Tensor                       # (C, 3)
    scales_raw: torch.Tensor                  # (C, 3)
    opacities_raw: torch.Tensor               # (C,)
    colors_raw: Optional[torch.Tensor] = None  # (C, 3) xor sh_raw
    sh_raw: Optional[torch.Tensor] = None      # (C, K, 3)
    alive: Optional[torch.Tensor] = None       # (C,) {0,1}; not trainable
    quats_raw: Optional[torch.Tensor] = None   # (C, 4) wxyz; EWA only

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def use_sh(self) -> bool:
        return self.sh_raw is not None

    @property
    def device(self) -> torch.device:
        return self.means.device

    def alive_mask(self) -> torch.Tensor:
        if self.alive is None:
            return torch.ones((self.capacity,), dtype=torch.float32,
                              device=self.device)
        return self.alive

    def num_alive(self) -> torch.Tensor:
        return self.alive_mask().sum().to(torch.int32)

    def replace(self, **kw) -> "RawParams":
        return dataclasses.replace(self, **kw)

    def to(self, device: Device) -> "RawParams":
        return RawParams(**{f.name: None if getattr(self, f.name) is None
                            else getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    def trainable(self) -> Dict[str, torch.Tensor]:
        """The optimizer-visible leaves (all but the alive mask)."""
        out = {"means": self.means, "scales_raw": self.scales_raw,
               "opacities_raw": self.opacities_raw}
        if self.use_sh:
            out["sh_raw"] = self.sh_raw
        else:
            out["colors_raw"] = self.colors_raw
        if self.quats_raw is not None:
            out["quats_raw"] = self.quats_raw
        return out

    def with_trainable(self, leaves: Mapping[str, torch.Tensor]
                       ) -> "RawParams":
        return self.replace(**leaves)


def init_params(generator: torch.Generator, num_gaussians: int,
                capacity: int, use_sh: bool = False, use_quats: bool = False,
                sh_degree: int = 1, device: Device = "cuda") -> RawParams:
    """Random init with the reference distributions, padded to capacity:
    rows [0, num_gaussians) are alive, the rest zero dead capacity. The
    draws come from `generator` on the CPU (means first, then colors)."""
    if num_gaussians > capacity:
        raise ValueError(f"num_gaussians {num_gaussians} > capacity {capacity}")
    dev = resolve_device(device)
    c, n = capacity, num_gaussians
    means = torch.zeros((c, 3), dtype=torch.float32)
    means[:n] = (torch.rand((n, 3), generator=generator) - 0.5) * 1.2
    dc = 0.1 * torch.rand((n, 3), generator=generator)
    raw = dict(means=means,
               scales_raw=torch.full((c, 3), -2.2),
               opacities_raw=torch.full((c,), -2.2),
               alive=(torch.arange(c) < n).to(torch.float32))
    if use_quats:
        raw["quats_raw"] = torch.zeros((c, 4))
        raw["quats_raw"][:, 0] = 1.0
    if use_sh:
        bands = sh_bands(sh_degree)
        if bands > 4:   # 3DGS convention: color = 0.5 + C0 * dc
            dc = (dc - 0.5) / SH_C0
        raw["sh_raw"] = torch.zeros((c, bands, 3))
        raw["sh_raw"][:n, 0, :] = dc
    else:
        raw["colors_raw"] = torch.zeros((c, 3))
        raw["colors_raw"][:n] = dc
    return RawParams(**{k: v.to(dev) for k, v in raw.items()})


def init_params_from_points(
    generator: torch.Generator, points, rgb, capacity: int,
    use_sh: bool = False, use_quats: bool = False, sh_degree: int = 1,
    device: Device = "cuda",
    draws: Optional[Tuple[Optional[np.ndarray], Optional[np.ndarray]]] = None,
) -> RawParams:
    """3DGS-style initialization from an SfM point cloud (e.g. COLMAP
    points3D), as `tpu_gaussians.models.gaussian_model`'s: means = points,
    color init from the point RGB, per-point scale from the
    nearest-neighbor distance (isotropic), opacity raw -2.2 like the
    reference init.

    points (P,3) / rgb (P,3 in [0,1]); P > capacity is subsampled
    uniformly. NN distance is estimated against <= 4096 random anchors
    (exact for P <= 4096), clipped to [1e-4, 0.1] x the cloud's extent.
    The two draws (subsample, then anchors; each without replacement) come
    from `generator` on the CPU, or from `draws` = (subsample indices or
    None, anchor indices or None), so that a test can start this package
    and the JAX one from the same indices.
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    col = np.clip(np.asarray(rgb, np.float32).reshape(-1, 3), 0.0, 1.0)
    p = pts.shape[0]
    if p == 0:
        raise ValueError("init_params_from_points: empty point cloud")

    def choose(drawn, k: int) -> np.ndarray:
        if draws is not None and drawn is not None:
            return np.asarray(drawn, np.int64)
        return torch.randperm(p, generator=generator)[:k].numpy()

    if p > capacity:
        sel = choose(draws[0] if draws else None, capacity)
        pts, col = pts[sel], col[sel]
        p = capacity

    # Per-point NN distance against a random anchor subset.
    n_anchor = min(p, 4096)
    anchor_idx = (np.arange(p) if n_anchor == p
                  else choose(draws[1] if draws else None, n_anchor))
    anchors = pts[anchor_idx]
    d2 = (np.sum(pts * pts, 1)[:, None] + np.sum(anchors * anchors, 1)[None]
          - 2.0 * pts @ anchors.T)
    d2[np.arange(p)[:, None] == anchor_idx[None, :]] = np.inf
    nn = np.sqrt(np.maximum(np.min(d2, axis=1), 1e-12))
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)) + 1e-6)
    nn = np.clip(nn, 1e-4 * extent, 0.1 * extent)
    # softplus(raw) + 1e-3 = nn  ->  raw = softplus^-1(nn - 1e-3)
    y = np.maximum(nn - 1e-3, 1e-6)
    scales_val = (y + np.log1p(-np.exp(-np.maximum(y, 1e-6)))
                  ).astype(np.float32)

    c = capacity
    means = torch.zeros((c, 3))
    means[:p] = torch.from_numpy(pts)
    scales_raw = torch.full((c, 3), -2.2)
    scales_raw[:p] = torch.from_numpy(scales_val)[:, None]
    raw = dict(means=means, scales_raw=scales_raw,
               opacities_raw=torch.full((c,), -2.2),
               alive=(torch.arange(c) < p).to(torch.float32))
    if use_quats:
        raw["quats_raw"] = torch.zeros((c, 4))
        raw["quats_raw"][:, 0] = 1.0
    if use_sh:
        bands = sh_bands(sh_degree)
        dc = torch.from_numpy(col)
        if bands > 4:   # 3DGS convention: color = 0.5 + C0 * dc
            dc = (dc - 0.5) / SH_C0
        raw["sh_raw"] = torch.zeros((c, bands, 3))
        raw["sh_raw"][:p, 0, :] = dc
    else:
        # colors = sigmoid(colors_raw): invert with a clamp away from {0,1}.
        cc = np.clip(col, 1e-4, 1.0 - 1e-4)
        raw["colors_raw"] = torch.zeros((c, 3))
        raw["colors_raw"][:p] = torch.from_numpy(
            (np.log(cc) - np.log1p(-cc)).astype(np.float32))
    dev = resolve_device(device)
    return RawParams(**{k: v.to(dev) for k, v in raw.items()})


def raw_from_numpy(arrays: Mapping[str, np.ndarray],
                   device: Device = "cuda") -> RawParams:
    """The leaves of a JAX-package `RawParams`, as numpy arrays keyed by
    field name (None or absent for unset fields), as this package's
    RawParams on `device`: one model carried into both packages bit for
    bit (the counterpart of `core.types.gaussians_from_numpy`)."""
    unknown = set(arrays) - set(LEAVES)
    if unknown:
        raise KeyError(f"unknown RawParams fields {sorted(unknown)}")
    dev = resolve_device(device)
    return RawParams(**{k: to_device(arrays[k], dev) for k in LEAVES
                        if arrays.get(k) is not None})


def _inv_softplus(y: np.ndarray) -> np.ndarray:
    return y + np.log1p(-np.exp(-y))


def raw_from_gaussians(g: Gaussians, capacity: int = 0) -> RawParams:
    """Invert the reference activations: activated Gaussians -> RawParams
    padded to `capacity` (0 = exactly the alive count), on g's device.
    Warm-starts a fit from an exported npz (--init_npz)."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    alive = host(g.alive_mask()) > 0.5
    means, scales, op = host(g.means)[alive], host(g.scales)[alive], \
        host(g.opacities)[alive]
    n = means.shape[0]
    c = max(capacity, n)

    def padded(rows, fill):
        out = np.full((c,) + rows.shape[1:], fill, np.float32)
        out[:n] = rows
        return out

    opc = np.clip(op, 1e-6, 1.0 - 1e-6)
    arrays = dict(
        means=padded(means, 0.0),
        scales_raw=padded(_inv_softplus(np.maximum(scales - 1e-3, 1e-6)),
                          -2.2),
        opacities_raw=padded(np.log(opc) - np.log1p(-opc), -2.2),
        alive=(np.arange(c) < n).astype(np.float32))
    if g.quats is not None:
        q = padded(host(g.quats)[alive], 0.0)
        q[n:, 0] = 1.0
        arrays["quats_raw"] = q
    if g.use_sh:
        arrays["sh_raw"] = padded(host(g.sh)[alive], 0.0)
    else:
        col = np.clip(host(g.colors)[alive], 1e-4, 1 - 1e-4)
        arrays["colors_raw"] = padded(np.log(col) - np.log1p(-col), 0.0)
    return raw_from_numpy(arrays, device=g.device)


def activate(raw: RawParams) -> Gaussians:
    """Raw -> render-ready activated Gaussians (reference activations).
    Quaternions pass through raw (normalised inside the EWA conic)."""
    return Gaussians(
        means=raw.means,
        scales=torch.nn.functional.softplus(raw.scales_raw) + 1e-3,
        opacities=torch.sigmoid(raw.opacities_raw),
        colors=None if raw.use_sh else torch.sigmoid(raw.colors_raw),
        sh=raw.sh_raw if raw.use_sh else None,
        alive=raw.alive_mask(),
        quats=raw.quats_raw,
    )

"""Camera math: perspective / look_at / orbit rigs / npz camera I/O.

The formulas of `tpu_gaussians.core.camera` (reference torch_renderer.py
and model_viewer_main.cpp): OpenGL-style perspective with m[3,2] = -1,
right-handed look_at with rows [s; u2; -f], both row-major float32. The
orbit rig is fit_multiview_stub.py's (radius 2.5, pitch 0.2, yaw =
2*pi*i/V, fovy 60 deg, near 0.01, far 100); the camera npz holds `view`
and `proj` arrays of shape (V,4,4).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from tpu_gaussians_torch.core.types import Camera, Device, to_device


def _f32(x, device: Device) -> torch.Tensor:
    """Tensors keep their device; anything else goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return to_device(x, device)


def perspective(fovy_deg: float, aspect: float, znear: float, zfar: float,
                device: Device = "cuda") -> torch.Tensor:
    """OpenGL-style perspective projection (torch_renderer.py:24-32)."""
    f = 1.0 / math.tan(math.radians(fovy_deg) * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return to_device(m, device)


def look_at(eye, target, up, device: Device = "cuda") -> torch.Tensor:
    """Right-handed look_at view matrix (torch_renderer.py:35-54), with
    the reference's 1e-8 norm guards. Tensor arguments keep their device;
    other array-likes go to `device`."""
    eye = _f32(eye, device)
    target = _f32(target, eye.device).to(eye.device)
    up = _f32(up, eye.device).to(eye.device)

    f = target - eye
    f = f / (torch.linalg.norm(f) + 1e-8)
    u = up / (torch.linalg.norm(up) + 1e-8)
    s = torch.linalg.cross(f, u)
    s = s / (torch.linalg.norm(s) + 1e-8)
    u2 = torch.linalg.cross(s, f)

    rot = torch.eye(4, dtype=torch.float32, device=eye.device)
    rot[0, :3] = s
    rot[1, :3] = u2
    rot[2, :3] = -f
    trans = torch.eye(4, dtype=torch.float32, device=eye.device)
    trans[:3, 3] = -eye
    return rot @ trans


def camera_position_from_view(view: torch.Tensor) -> torch.Tensor:
    """World-space camera center = inv(view)[:3, 3] via the rigid-transform
    closed form -R^T t."""
    rot = view[..., :3, :3]
    t = view[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", rot, t)


def orbit_cameras(
    num_views: int,
    width: int,
    height: int,
    *,
    radius: float = 2.5,
    pitch: float = 0.2,
    fovy_deg: float = 60.0,
    znear: float = 0.01,
    zfar: float = 100.0,
    device: Device = "cuda",
) -> Camera:
    """Fallback orbit rig (fit_multiview_stub.py:70-90) as a batched Camera
    with stacked (V,4,4) matrices."""
    proj = perspective(fovy_deg, width / height, znear, zfar, device=device)
    views = []
    for i in range(num_views):
        yaw = (2.0 * math.pi * i) / max(1, num_views)
        eye = [radius * math.cos(pitch) * math.sin(yaw),
               radius * math.sin(pitch),
               radius * math.cos(pitch) * math.cos(yaw)]
        views.append(look_at(eye, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                             device=device))
    return Camera(view=torch.stack(views, dim=0),
                  proj=proj.expand(num_views, 4, 4).contiguous())


def load_cameras_npz(path: Union[str, Path],
                     expected_views: Optional[int] = None,
                     device: Device = "cuda") -> Camera:
    """Load a camera npz with `view`/`proj` (V,4,4) arrays."""
    data = np.load(Path(path))
    if "view" not in data or "proj" not in data:
        raise KeyError("camera npz must contain arrays: view (V,4,4), proj (V,4,4)")
    views = np.asarray(data["view"], dtype=np.float32)
    projs = np.asarray(data["proj"], dtype=np.float32)
    if views.ndim != 3 or views.shape[1:] != (4, 4) or projs.shape != views.shape:
        raise ValueError("view/proj must both be (V,4,4)")
    if expected_views is not None and views.shape[0] != expected_views:
        raise ValueError("camera count mismatch with number of target images")
    return Camera(view=to_device(views, device),
                  proj=to_device(projs, device))


def save_cameras_npz(path: Union[str, Path], cameras: Camera) -> None:
    view = cameras.view.detach().cpu().numpy().astype(np.float32)
    proj = cameras.proj.detach().cpu().numpy().astype(np.float32)
    if view.ndim == 2:
        view = view[None]
        proj = proj[None]
    np.savez(Path(path), view=view, proj=proj)

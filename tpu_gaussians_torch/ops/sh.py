"""View-dependent color: RGB passthrough, reference SH-1, or 3DGS SH-2/3.

The three flavours of `tpu_gaussians.ops.sh`, selected by shape:

  RGB (N,3): returned as-is.
  SH  (N,4,3), the reference convention (torch_renderer.py:86-106):
    c = dc + c1x*dir_x + c1y*dir_y + c1z*dir_z with
    dir = normalize(cam_pos - mean) and the 1e-8 norm guard.
  SH  (N,9,3) / (N,16,3), the 3DGS real-SH convention (degree 2 / 3):
    c = 0.5 + sum_lm coeff_lm * Y_lm(dir), dir = normalize(mean - cam_pos).

The caller clamps the result to [0,1].
"""

from __future__ import annotations

import torch

from tpu_gaussians_torch.core.camera import camera_position_from_view

# Standard real-SH constants (3DGS / gsplat convention).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def _eval_sh3dgs(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Standard 3DGS SH evaluation for K in {9, 16} coefficient rows."""
    x = dirs[:, 0:1]
    y = dirs[:, 1:2]
    z = dirs[:, 2:3]
    out = 0.5 + SH_C0 * sh[:, 0, :]
    out = (out
           - SH_C1 * y * sh[:, 1, :]
           + SH_C1 * z * sh[:, 2, :]
           - SH_C1 * x * sh[:, 3, :])
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = (out
           + SH_C2[0] * xy * sh[:, 4, :]
           + SH_C2[1] * yz * sh[:, 5, :]
           + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6, :]
           + SH_C2[3] * xz * sh[:, 7, :]
           + SH_C2[4] * (xx - yy) * sh[:, 8, :])
    if sh.shape[1] == 16:
        out = (out
               + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9, :]
               + SH_C3[1] * xy * z * sh[:, 10, :]
               + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11, :]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12, :]
               + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13, :]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14, :]
               + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15, :])
    return out


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.linalg.norm(d, dim=1, keepdim=True) + 1e-8)


def eval_colors(colors_or_sh: torch.Tensor, means: torch.Tensor,
                view: torch.Tensor) -> torch.Tensor:
    """Evaluate per-Gaussian RGB for one camera."""
    c = colors_or_sh
    if c.ndim == 2 and c.shape[1] == 3:
        return c
    if c.ndim == 3 and c.shape[1] == 4 and c.shape[2] == 3:
        dirs = _unit(camera_position_from_view(view)[None, :] - means)
        return (c[:, 0, :]
                + c[:, 1, :] * dirs[:, 0:1]
                + c[:, 2, :] * dirs[:, 1:2]
                + c[:, 3, :] * dirs[:, 2:3])
    if c.ndim == 3 and c.shape[1] in (9, 16) and c.shape[2] == 3:
        dirs = _unit(means - camera_position_from_view(view)[None, :])
        return _eval_sh3dgs(c, dirs)
    raise ValueError(
        "colors must be (N,3), reference SH (N,4,3), or 3DGS SH (N,9,3)/"
        f"(N,16,3); got {tuple(c.shape)}")

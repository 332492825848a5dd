"""EWA splatting: quaternion rotation + full 3D covariance -> 2D conic.

The math of `tpu_gaussians.ops.ewa` (3D Gaussian Splatting / EWA
splatting):

  R = quat_to_rot(q)                     (unit quaternion, wxyz)
  Sigma3 = R diag(s)^2 R^T               world-space covariance
  t = view @ [mean, 1]                   camera-space center
  J = d(pixel)/d(t)                      perspective Jacobian at t for this
                                         package's pixel mapping (x right,
                                         y DOWN: the y-flip folds a sign
                                         into J's second row)
  Sigma2 = J V Sigma3 V^T J^T + blur*I   (V = view rotation; 0.3 px
                                         low-pass dilation like 3DGS)
  conic (a, b, c) = inverse(Sigma2)      footprint: w = op*exp(-0.5*
                                         (a dx^2 + 2b dx dy + c dy^2))

and the reference's axis-aligned footprint as a conic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(N,4) wxyz quaternions -> (N,3,3) rotation matrices. Normalizes."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


class Conic(NamedTuple):
    a: torch.Tensor        # (N,)
    b: torch.Tensor        # (N,)
    c: torch.Tensor        # (N,)
    sigma_x: torch.Tensor  # (N,) effective x stddev in pixels (culling/bbox)
    sigma_y: torch.Tensor  # (N,) effective y stddev in pixels


def axis_aligned_conic(sigma_x: torch.Tensor,
                       sigma_y: torch.Tensor) -> Conic:
    """The reference footprint as a conic: a=1/sx^2, b=0, c=1/sy^2."""
    return Conic(a=1.0 / (sigma_x * sigma_x), b=torch.zeros_like(sigma_x),
                 c=1.0 / (sigma_y * sigma_y), sigma_x=sigma_x,
                 sigma_y=sigma_y)


def ewa_conic(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    view: torch.Tensor,
    proj: torch.Tensor,
    width: int,
    height: int,
    blur: float = 0.3,
    min_sigma: float = 0.3,
) -> Conic:
    """Full EWA projected conic for each gaussian.

    means (N,3), scales (N,3), quats (N,4) wxyz, view/proj (4,4).
    `blur` is the screen-space low-pass dilation (pixels^2); `min_sigma`
    floors the culling sigmas.
    """
    rot = quat_to_rot(quats)                             # (N,3,3)
    rs = rot * (scales * scales)[:, None, :]             # R @ diag(s^2)
    sigma3 = torch.einsum("nij,nkj->nik", rs, rot)       # (N,3,3)

    vrot = view[:3, :3]
    t = means @ vrot.T + view[:3, 3]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    tz = torch.where(tz.abs() < 1e-6,
                     torch.sign(tz) * 1e-6 + (tz == 0).to(tz.dtype) * 1e-6,
                     tz)

    # px = (ndc_x*0.5 + 0.5)*(W-1), ndc_x = fx * tx / (-tz) for the OpenGL
    # proj (w = -tz), so d(px)/d(tx) = 0.5*(W-1)*fx / (-tz).
    fx = proj[0, 0].abs() * 0.5 * (width - 1)
    fy = proj[1, 1].abs() * 0.5 * (height - 1)
    inv_mz = 1.0 / (-tz)                                 # camera looks down -z
    j00 = fx * inv_mz
    j02 = fx * tx * inv_mz * inv_mz
    j11 = -fy * inv_mz
    j12 = -fy * ty * inv_mz * inv_mz

    cov_cam = torch.einsum("ij,njk,lk->nil", vrot, sigma3, vrot)
    zero = torch.zeros_like(j00)
    r0 = torch.stack([j00, zero, j02], dim=-1)           # (N,3)
    r1 = torch.stack([zero, j11, j12], dim=-1)
    m00 = torch.einsum("ni,nij,nj->n", r0, cov_cam, r0) + blur
    m01 = torch.einsum("ni,nij,nj->n", r0, cov_cam, r1)
    m11 = torch.einsum("ni,nij,nj->n", r1, cov_cam, r1) + blur

    # f32 overflow guard: splats crossing the camera plane blow J up and
    # det would become inf - inf; clamp to a huge-but-finite PSD ceiling.
    cap = 1e10
    m00 = torch.clamp(m00, 1e-8, cap)
    m11 = torch.clamp(m11, 1e-8, cap)
    m01_bound = 0.999 * torch.sqrt(m00 * m11)
    m01 = torch.clamp(m01, -m01_bound, m01_bound)

    det = torch.clamp(m00 * m11 - m01 * m01, min=1e-12)
    a = m11 / det
    b = -m01 / det
    c = m00 / det
    sigma_x = torch.sqrt(torch.clamp(m00, min=min_sigma ** 2))
    sigma_y = torch.sqrt(torch.clamp(m11, min=min_sigma ** 2))
    return Conic(a=a, b=b, c=c, sigma_x=sigma_x, sigma_y=sigma_y)

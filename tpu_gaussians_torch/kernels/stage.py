"""The per-gaussian stage as one autograd Function: the CUDA kernels'
wrapper and their plain twins.

`stage` computes, for one camera, what `ops.common.prepare_splats` hands
to compositing: rows (8, N) = [px, py, conic_a, conic_b, conic_c, sigma_x,
sigma_y, op_eff] and feats (N, 5) = [r, g, b, 1, z_abs], returned as the
eight rows (contiguous views of one buffer) and feats. On CUDA tensors its
forward and its backward each launch `csrc/stage.cu` once; on CPU tensors
its forward is `stage_fwd_plain` (the stage's plain composition, run
without autograd) and its backward `stage_bwd_plain`, the kernel's
hand-derived formulas in torch. It never falls back from one to the
other. It replaces no TPU kernel: XLA fused the JAX stage
(`tpu_gaussians/ops/common.py:prepare_splats`).

The footprint (`ewa`) and the colour kind, read from the colour tensor's
shape ((N,3) RGB, (N,4,3) the reference's linear SH1, (N,9,3) / (N,16,3)
3DGS SH2 / SH3), choose the kernels' template instance. The backward
saves only the inputs and recomputes the forward; it gives no gradient to
the camera or the alive mask, and the wrapper refuses them when they
require one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from tpu_gaussians_torch.core.camera import camera_position_from_view
from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.ops.ewa import (
    axis_aligned_conic, ewa_conic, ewa_cov2d)
from tpu_gaussians_torch.ops.projection import axis_sigma, clip_space, project
from tpu_gaussians_torch.ops.sh import SH_C0, SH_C1, SH_C2, SH_C3, eval_colors
from tpu_gaussians_torch.utils.profiling import annotate

ROWS = 8       # px, py, conic_a, conic_b, conic_c, sigma_x, sigma_y, op_eff
FEATS = 5      # r, g, b, 1, z_abs
BLUR = 0.3     # ewa_conic's defaults
MIN_SIGMA2 = 0.3 ** 2

launches = {"stage_fwd": 0, "stage_bwd": 0}   # kernel launches by stage

Inputs = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               torch.Tensor, torch.Tensor]


def _check(means, scales, quats, colors, opacities, alive, view, proj
           ) -> int:
    """The SH rows of the colour tensor (0 for RGB); raises on anything
    the kernels do not take."""
    n = means.shape[0] if means.ndim == 2 else -1
    shapes = {"means": (means, (n, 3)), "scales": (scales, (n, 3)),
              "quats": (quats, (n, 4)), "opacities": (opacities, (n,)),
              "alive": (alive, (n,)), "view": (view, (4, 4)),
              "proj": (proj, (4, 4))}
    if colors.ndim == 2 and colors.shape[1] == 3:
        sh_k = 0
    elif colors.ndim == 3 and colors.shape[1] in (4, 9, 16) \
            and colors.shape[2] == 3:
        sh_k = colors.shape[1]
    else:
        raise ValueError(
            "colors must be (N,3), reference SH (N,4,3), or 3DGS SH (N,9,3)/"
            f"(N,16,3); got {tuple(colors.shape)}")
    shapes["colors"] = (colors, (n,) + tuple(colors.shape[1:]))
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"stage: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"stage: {name} must be float32, got {t.dtype}")
        if t.device != means.device:
            raise ValueError(f"stage: {name} is on {t.device}, means on "
                             f"{means.device}")
        if not t.is_contiguous():
            raise ValueError(f"stage: {name} must be contiguous")
    for name, t in (("view", view), ("proj", proj), ("alive", alive)):
        if t is not None and t.requires_grad:
            raise ValueError(f"stage: {name} requires grad, but the stage "
                             "gives it none")
    return sh_k


def _quats_or_identity(quats, means):
    """quats, or the identity (wxyz = 1, 0, 0, 0) for every gaussian."""
    if quats is not None:
        return quats
    q = torch.zeros((means.shape[0], 4), dtype=means.dtype,
                    device=means.device)
    q[:, 0] = 1.0
    return q


def stage_fwd_plain(means, scales, quats, colors, opacities, alive, view,
                    proj, width: int, height: int, ewa: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stage's plain composition -> (rows (8, N), feats (N, 5)):
    projection, footprint conic, colour clamped to [0, 1], the validity and
    alive masks folded into the opacity. Differentiable where autograd is
    on (the card tests hold the kernels' gradients to it)."""
    s = project(means, view, proj, width, height, scales)
    rgb = torch.clamp(eval_colors(colors, means, view), 0.0, 1.0)
    if ewa:
        conic = ewa_conic(means, scales, _quats_or_identity(quats, means),
                          view, proj, width, height)
    else:
        conic = axis_aligned_conic(s.sigma_x, s.sigma_y)
    op_eff = torch.clamp(opacities, min=0.0) * s.valid
    if alive is not None:
        op_eff = op_eff * alive
    feats = torch.cat([rgb, torch.ones_like(s.z_abs)[:, None],
                       s.z_abs[:, None]], dim=1)
    rows = torch.stack([s.px, s.py, conic.a, conic.b, conic.c,
                        conic.sigma_x, conic.sigma_y, op_eff])
    return rows, feats


def _clamp_pass(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """Where torch.clamp passes its gradient: lo <= x <= hi."""
    ok = torch.ones_like(x, dtype=torch.bool)
    if lo is not None:
        ok &= x >= lo
    if hi is not None:
        ok &= x <= hi
    return ok


def _sh3dgs_grads(g_col, sh, x, y, z):
    """3DGS SH of degree 2 or 3 (sh (N, 9|16, 3)): the gradients of the
    coefficients and of the direction (x, y, z), each (N,) or (N, 1)."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    basis = [SH_C0 * one, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
             SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    zero = torch.zeros_like(x)
    # d basis / d (x, y, z)
    dbasis = [(zero, zero, zero), (zero, -SH_C1 * one, zero),
              (zero, zero, SH_C1 * one), (-SH_C1 * one, zero, zero),
              (SH_C2[0] * y, SH_C2[0] * x, zero),
              (zero, SH_C2[1] * z, SH_C2[1] * y),
              (-2.0 * SH_C2[2] * x, -2.0 * SH_C2[2] * y, 4.0 * SH_C2[2] * z),
              (SH_C2[3] * z, zero, SH_C2[3] * x),
              (2.0 * SH_C2[4] * x, -2.0 * SH_C2[4] * y, zero)]
    if sh.shape[1] == 16:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
        dbasis += [
            (SH_C3[0] * 6.0 * xy, SH_C3[0] * 3.0 * (xx - yy), zero),
            (SH_C3[1] * yz, SH_C3[1] * xz, SH_C3[1] * xy),
            (-SH_C3[2] * 2.0 * xy, SH_C3[2] * (4.0 * zz - xx - 3.0 * yy),
             SH_C3[2] * 8.0 * yz),
            (-SH_C3[3] * 6.0 * xz, -SH_C3[3] * 6.0 * yz,
             SH_C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
            (SH_C3[4] * (4.0 * zz - 3.0 * xx - yy), -SH_C3[4] * 2.0 * xy,
             SH_C3[4] * 8.0 * xz),
            (SH_C3[5] * 2.0 * xz, -SH_C3[5] * 2.0 * yz, SH_C3[5] * (xx - yy)),
            (SH_C3[6] * 3.0 * (xx - yy), -SH_C3[6] * 6.0 * xy, zero)]
    g_sh = torch.stack([g_col * b for b in basis], dim=1)
    gk = (g_col[:, None, :] * sh).sum(dim=2)              # (N, K)
    g_dir = [sum(gk[:, k:k + 1] * db[a] for k, db in enumerate(dbasis))
             for a in range(3)]
    return g_sh, torch.cat(g_dir, dim=1)


def stage_bwd_plain(means, scales, quats, colors, opacities, alive, view,
                    proj, width: int, height: int, ewa: bool,
                    grads: Sequence[Optional[torch.Tensor]],
                    needs: Sequence[bool]) -> List[Optional[torch.Tensor]]:
    """The kernel's backward in torch: the gradients of (means, scales,
    quats, colors, opacities) from the cotangents of the eight rows and of
    feats (None: zero), each None where `needs` does not ask for it. The
    forward's terms are recomputed with the plain composition's own
    expressions, so every clamp and branch decides as it decided."""
    n = means.shape[0]
    zero = torch.zeros((n,), dtype=means.dtype, device=means.device)
    g_px, g_py, g_a, g_b, g_c, g_sx, g_sy, g_op = (
        zero if g is None else g for g in grads[:ROWS])
    g_feats = (torch.zeros((n, FEATS), dtype=means.dtype,
                           device=means.device)
               if grads[ROWS] is None else grads[ROWS])

    # projection: px, py through ndc = clip / w_safe; z_abs
    p_cam, p_clip, w_safe = clip_space(means, view, proj)
    w, w_safe = p_clip[:, 3], w_safe[:, 0]
    ndc = p_clip[:, :3] / w_safe[:, None]
    valid = ((ndc[:, 2] >= -1.0) & (ndc[:, 2] <= 1.0)
             & (w != 0.0)).to(torch.float32)
    z_raw = p_cam[:, 2].abs()
    z_abs = torch.clamp(z_raw, min=1e-6)
    g_ndc0 = g_px * (0.5 * (width - 1))
    g_ndc1 = g_py * (-0.5 * (height - 1))
    g_w = torch.where(w.abs() < 1e-8, zero,
                      -(g_ndc0 * ndc[:, 0] + g_ndc1 * ndc[:, 1]) / w_safe)
    g_clip = torch.stack([g_ndc0 / w_safe, g_ndc1 / w_safe, zero, g_w], 1)
    g_pc = g_clip @ proj                                   # (N, 4)
    g_zabs = g_feats[:, 4]
    g_scales = torch.zeros_like(scales)
    g_quats = None

    if not ewa:
        for k, (g_sig, g_con, size, focal) in enumerate((
                (g_sx, g_a, width, proj[0, 0]),
                (g_sy, g_c, height, proj[1, 1]))):
            u = axis_sigma(scales[:, k], size, focal, z_abs)
            sig = torch.clamp(u, min=1.0)
            g_u = torch.where(_clamp_pass(u, lo=1.0),
                              g_sig - 2.0 * g_con / (sig * sig * sig), zero)
            g_scales[:, k] = (g_u * torch.sign(scales[:, k]) * 0.5 * size
                              * focal.abs() / z_abs)
            g_zabs = g_zabs - g_u * u / z_abs
    else:
        q = _quats_or_identity(quats, means)
        e = ewa_cov2d(means, scales, q, view, proj, width, height, BLUR)
        m00c = torch.clamp(e.m00, 1e-8, 1e10)
        m11c = torch.clamp(e.m11, 1e-8, 1e10)
        root = torch.sqrt(m00c * m11c)
        bnd = 0.999 * root
        m01c = torch.clamp(e.m01, -bnd, bnd)
        d_raw = m00c * m11c - m01c * m01c
        det = torch.clamp(d_raw, min=1e-12)
        a, b, c = m11c / det, -m01c / det, m00c / det
        # conic (m11, -m01, m00) / det and sigma = sqrt(max(m, 0.09))
        g_m00c = g_c / det + torch.where(
            _clamp_pass(m00c, lo=MIN_SIGMA2),
            g_sx * 0.5 / torch.sqrt(torch.clamp(m00c, min=MIN_SIGMA2)), zero)
        g_m11c = g_a / det + torch.where(
            _clamp_pass(m11c, lo=MIN_SIGMA2),
            g_sy * 0.5 / torch.sqrt(torch.clamp(m11c, min=MIN_SIGMA2)), zero)
        g_m01c = -g_b / det
        g_det = -(g_a * a + g_b * b + g_c * c) / det
        g_d = torch.where(_clamp_pass(d_raw, lo=1e-12), g_det, zero)
        g_m00c = g_m00c + g_d * m11c
        g_m11c = g_m11c + g_d * m00c
        g_m01c = g_m01c - 2.0 * g_d * m01c
        # the clamp of m01 to tensor bounds: past a bound, into that bound
        lo, hi, m01 = -bnd, bnd, e.m01
        g01 = torch.where(_clamp_pass(m01, lo, hi), g_m01c, zero)
        g_lo = torch.where((m01 < lo) & (lo < hi), g_m01c, zero)
        g_hi = torch.where((m01 > hi) | (hi < lo), g_m01c, zero)
        g_prod = (g_hi - g_lo) * 0.999 * 0.5 / root
        g_m00c = g_m00c + g_prod * m11c
        g_m11c = g_m11c + g_prod * m00c
        g00 = torch.where(_clamp_pass(e.m00, 1e-8, 1e10), g_m00c, zero)
        g11 = torch.where(_clamp_pass(e.m11, 1e-8, 1e10), g_m11c, zero)

        # m = r^T C r' with r0 = (j00, 0, j02), r1 = (0, j11, j12), C
        # symmetric
        cc = 0.5 * (e.cov_cam + e.cov_cam.transpose(1, 2))
        c00, c01, c02 = cc[:, 0, 0], cc[:, 0, 1], cc[:, 0, 2]
        c11, c12, c22 = cc[:, 1, 1], cc[:, 1, 2], cc[:, 2, 2]
        j00, j02, j11, j12 = e.j00, e.j02, e.j11, e.j12
        g_j00 = (g00 * (2.0 * j00 * c00 + 2.0 * j02 * c02)
                 + g01 * (j11 * c01 + j12 * c02))
        g_j02 = (g00 * (2.0 * j00 * c02 + 2.0 * j02 * c22)
                 + g01 * (j11 * c12 + j12 * c22))
        g_j11 = (g11 * (2.0 * j11 * c11 + 2.0 * j12 * c12)
                 + g01 * (j00 * c01 + j02 * c12))
        g_j12 = (g11 * (2.0 * j11 * c12 + 2.0 * j12 * c22)
                 + g01 * (j00 * c02 + j02 * c22))
        r0 = torch.stack([j00, zero, j02], 1)
        r1 = torch.stack([zero, j11, j12], 1)
        outer = r0[:, :, None] * r1[:, None, :]
        g_cov = (g00[:, None, None] * r0[:, :, None] * r0[:, None, :]
                 + g11[:, None, None] * r1[:, :, None] * r1[:, None, :]
                 + 0.5 * g01[:, None, None] * (outer + outer.transpose(1, 2)))

        # the Jacobian's entries -> t (t_z's 1e-6 replacement a constant)
        fx = proj[0, 0].abs() * 0.5 * (width - 1)
        fy = proj[1, 1].abs() * 0.5 * (height - 1)
        tx, ty, inv = e.t[:, 0], e.t[:, 1], e.inv_mz
        g_inv = (g_j00 * fx + g_j02 * fx * tx * 2.0 * inv
                 - g_j11 * fy - g_j12 * fy * ty * 2.0 * inv)
        g_t = torch.stack([
            g_j02 * fx * inv * inv, -g_j12 * fy * inv * inv,
            torch.where(e.t[:, 2].abs() < 1e-6, zero, g_inv * inv * inv)], 1)
        g_pc = g_pc + torch.cat([g_t, zero[:, None]], dim=1)

        # Sigma3 = R diag(s^2) R^T, cov_cam = Vr Sigma3 Vr^T
        vrot = view[:3, :3]
        g_s3 = vrot.T @ g_cov @ vrot
        rot, s2 = e.rot, scales * scales
        g_rot = 2.0 * (g_s3 @ rot) * s2[:, None, :]
        g_s2 = torch.einsum("nrb,nrc,ncb->nb", rot, g_s3, rot)
        g_scales = 2.0 * scales * g_s2
        if needs[2]:
            qn = q / (torch.linalg.norm(q, dim=1, keepdim=True) + 1e-12)
            w_, x, y, z = qn.unbind(1)
            gr = g_rot
            gq = 2.0 * torch.stack([
                -z * gr[:, 0, 1] + y * gr[:, 0, 2] + z * gr[:, 1, 0]
                - x * gr[:, 1, 2] - y * gr[:, 2, 0] + x * gr[:, 2, 1],
                y * gr[:, 0, 1] + z * gr[:, 0, 2] + y * gr[:, 1, 0]
                - 2.0 * x * gr[:, 1, 1] - w_ * gr[:, 1, 2] + z * gr[:, 2, 0]
                + w_ * gr[:, 2, 1] - 2.0 * x * gr[:, 2, 2],
                -2.0 * y * gr[:, 0, 0] + x * gr[:, 0, 1] + w_ * gr[:, 0, 2]
                + x * gr[:, 1, 0] + z * gr[:, 1, 2] - w_ * gr[:, 2, 0]
                + z * gr[:, 2, 1] - 2.0 * y * gr[:, 2, 2],
                -2.0 * z * gr[:, 0, 0] - w_ * gr[:, 0, 1] + x * gr[:, 0, 2]
                + w_ * gr[:, 1, 0] - 2.0 * z * gr[:, 1, 1] + y * gr[:, 1, 2]
                + x * gr[:, 2, 0] + y * gr[:, 2, 1]], dim=1)
            g_quats = _unit_grad(gq, q, 1e-12)

    # z_abs = max(|p_cam_z|, 1e-6)
    g_pc[:, 2] += torch.where(_clamp_pass(z_raw, lo=1e-6),
                              g_zabs * torch.sign(p_cam[:, 2]), zero)
    g_means = g_pc @ view[:, :3]

    # colour, clamped to [0, 1]
    col = eval_colors(colors, means, view)
    g_col = torch.where(_clamp_pass(col, 0.0, 1.0), g_feats[:, :3],
                        torch.zeros_like(col))
    if colors.ndim == 2:
        g_colors = g_col
    else:
        cam = camera_position_from_view(view)[None, :]
        ref = colors.shape[1] == 4
        dvec = cam - means if ref else means - cam
        dirs = dvec / (torch.linalg.norm(dvec, dim=1, keepdim=True) + 1e-8)
        if ref:
            basis = [torch.ones_like(dirs[:, :1]), dirs[:, 0:1],
                     dirs[:, 1:2], dirs[:, 2:3]]
            g_colors = torch.stack([g_col * bk for bk in basis], dim=1)
            g_dir = (g_col[:, None, :] * colors[:, 1:]).sum(dim=2)
        else:
            g_colors, g_dir = _sh3dgs_grads(g_col, colors, dirs[:, 0:1],
                                            dirs[:, 1:2], dirs[:, 2:3])
        g_d = _unit_grad(g_dir, dvec, 1e-8)
        g_means = g_means - g_d if ref else g_means + g_d

    g_opac = torch.where(opacities >= 0.0, g_op * valid, zero)
    if alive is not None:
        g_opac = g_opac * alive
    out = [g_means, g_scales, g_quats, g_colors, g_opac]
    return [g if need else None for g, need in zip(out, needs)]


def _unit_grad(g_unit: torch.Tensor, v: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """The gradient of v from that of v / (|v| + eps), rows of (N, k);
    torch's norm passes nothing where |v| = 0."""
    nrm = torch.linalg.norm(v, dim=1, keepdim=True)
    den = nrm + eps
    dot = (g_unit * v).sum(dim=1, keepdim=True)
    k = torch.where(nrm > 0, dot / (den * den * torch.where(
        nrm > 0, nrm, torch.ones_like(nrm))), torch.zeros_like(nrm))
    return g_unit / den - v * k


def _fwd(inputs: Inputs, width: int, height: int, ewa: bool, sh_k: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    means = inputs[0]
    if not build.on_cuda("stage", means, float4=False):
        return stage_fwd_plain(*inputs, width, height, ewa)
    n = means.shape[0]
    rows = torch.empty((ROWS, n), dtype=torch.float32, device=means.device)
    feats = torch.empty((n, FEATS), dtype=torch.float32, device=means.device)
    build.launch("stage", (*inputs, rows, feats), n, width, height, int(ewa),
                 sh_k, entry="stage_fwd")
    launches["stage_fwd"] += 1
    return rows, feats


def _bwd(inputs: Inputs, width: int, height: int, ewa: bool, sh_k: int,
         grads: Sequence[Optional[torch.Tensor]], needs: Sequence[bool]
         ) -> List[Optional[torch.Tensor]]:
    means = inputs[0]
    n = means.shape[0]
    for k, g in enumerate(grads):
        shape = (n,) if k < ROWS else (n, FEATS)
        if g is not None and (tuple(g.shape) != shape
                              or g.dtype != torch.float32
                              or g.device != means.device):
            raise ValueError(f"stage: cotangent {k} must be float32 {shape} "
                             f"on {means.device}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
    if not build.on_cuda("stage", means, float4=False):
        return stage_bwd_plain(*inputs, width, height, ewa, grads, needs)
    outs = [torch.empty_like(t) if need and t is not None else None
            for t, need in zip(inputs[:5], needs)]
    strides = [0 if g is None else g.stride(0) for g in grads[:ROWS]]
    gf = grads[ROWS]
    strides += [0, 0] if gf is None else [gf.stride(0), gf.stride(1)]
    build.launch("stage", (*inputs, *grads, *outs), n, width, height,
                 int(ewa), sh_k, *strides, entry="stage_bwd")
    launches["stage_bwd"] += 1
    return outs


class _Stage(torch.autograd.Function):
    """Forward: the eight rows and feats. Backward: the gradients of means,
    scales, quats, the colour or SH tensor and opacities; none for the
    alive mask and the camera."""

    @staticmethod
    def forward(ctx, means, scales, quats, colors, opacities, alive, view,
                proj, width, height, ewa, sh_k):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means, scales, quats, colors, opacities,
                              alive, view, proj)
        ctx.frame = (width, height, ewa, sh_k)
        rows, feats = _fwd((means, scales, quats, colors, opacities, alive,
                            view, proj), width, height, ewa, sh_k)
        return (*rows.unbind(0), feats)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:5]
        if not any(needs) or all(g is None for g in grads):
            return (None,) * 12
        with annotate("gs.stage.bwd"):
            outs = _bwd(ctx.saved_tensors, *ctx.frame, grads, needs)
        return (*outs, None, None, None, None, None, None, None)


def stage(means: torch.Tensor, scales: torch.Tensor,
          quats: Optional[torch.Tensor], colors: torch.Tensor,
          opacities: torch.Tensor, alive: Optional[torch.Tensor],
          view: torch.Tensor, proj: torch.Tensor, width: int, height: int,
          ewa: bool) -> Tuple[torch.Tensor, ...]:
    """(px, py, conic_a, conic_b, conic_c, sigma_x, sigma_y, op_eff, feats)
    of every gaussian for one camera, differentiable in means, scales,
    quats, colors and opacities. quats None is the identity (EWA only),
    alive None all alive; colors (N,3) RGB or (N,K,3) SH. The axis
    footprint reads no quaternions: they get no gradient there."""
    quats = quats if ewa else None
    sh_k = _check(means, scales, quats, colors, opacities, alive, view, proj)
    return _Stage.apply(means, scales, quats, colors, opacities, alive, view,
                        proj, width, height, bool(ewa), sh_k)

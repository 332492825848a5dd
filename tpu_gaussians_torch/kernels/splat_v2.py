"""General-conic (EWA) band accumulation, forward and backward: the CUDA
kernels' wrappers and their plain twins.

`splat_v2_fwd` launches `csrc/splat_v2_fwd.cu` (K5, the replacement of the
TPU kernel `tpu_gaussians/ops/pallas/splat.py:_fwd_kernel_v2`) and
`splat_v2_bwd` launches `csrc/splat_v2_bwd.cu` (K6, replacing
`_bwd_kernel_v2`) for CUDA tensors; for CPU tensors each runs its plain
twin (`v2_fwd_plain`, `v2_bwd_plain`), the same banded range loop in torch.
Neither falls back from one to the other.

Inputs:
  lo, cnt (n_bands,) int32: band i (pixels [i*2048, (i+1)*2048) of the
      row-major frame, padded to hw_pad = n_bands*2048) evaluates the
      gaussians of blocks [lo[i], lo[i] + cnt[i]) of nb gaussians;
  gdata (n_pad, 16) f32 row-major rows [px, py, a', b', c', op,
      featsop(8), 0, 0], with the conic pre-scaled (a' = -a/2, b' = -b,
      c' = -c/2) and featsop_f = feats_f * op.
Output acc (8, hw_pad) f32: with dx = x - px, dy = y - py at pixel
centres (+0.5),
  acc[f, p] = sum_g featsop_f exp(dx (a' dx + b' dy) + c' dy^2).
K6 takes g8 (8, hw_pad), the cotangent of acc, and returns (n_pad, 16) rows
[Mdx, Mdy, Mxx, Mxy, Myy, 0, g_featop(8), 0, 0] summed over every band whose
range holds the gaussian, where with x = exp(...) as above,
  g_e = x sum_f g8[f, p] featsop_f,  Mdx = sum_p g_e dx, Mdy = sum_p g_e dy,
  Mxx = sum_p g_e dx^2, Mxy = sum_p g_e dx dy, Myy = sum_p g_e dy^2,
  g_featop_f = sum_p g8[f, p] x.
"""

from __future__ import annotations

import functools

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.kernels.splat_sep import GD_FEAT0, GD_ROWS

TP2 = 2048      # pixels per band
FEAT_PAD = 8    # output rows
BLOCK = 128     # nb is a multiple of this (ops/splat._v2_block)

# The twins' exponent floor. torch's CPU exp takes a slow path below
# about -87 (denormal results), where most far (gaussian, pixel) pairs
# lie; the kernels cut nothing off. exp(-60) = 8.8e-27, so the floor moves
# a pair's term by at most 8.8e-27 times its coefficient (feats, or g8 and
# up to dx^2 ~ 1e6 in a moment): about 1e-13 summed over a whole frame at
# 1e6 pixels, far below every tolerance the twins are held to.
EXP_FLOOR = -60.0

launches = {"splat_v2_fwd": 0, "splat_v2_bwd": 0}   # kernel launches


def _check(lo, cnt, gdata, hw_pad: int, width: int, nb: int) -> None:
    if not (lo.device == cnt.device == gdata.device):
        raise ValueError(f"lo on {lo.device}, cnt on {cnt.device}, gdata on "
                         f"{gdata.device}")
    if lo.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise ValueError(f"lo and cnt must be int32, got {lo.dtype} / "
                         f"{cnt.dtype}")
    if gdata.dtype != torch.float32:
        raise ValueError(f"gdata must be float32, got {gdata.dtype}")
    if lo.ndim != 1 or lo.shape != cnt.shape or lo.shape[0] * TP2 != hw_pad:
        raise ValueError(f"lo and cnt must be (hw_pad / {TP2},) = "
                         f"({hw_pad // TP2},), got {tuple(lo.shape)} / "
                         f"{tuple(cnt.shape)}")
    if width <= 0 or nb <= 0 or nb % BLOCK:
        raise ValueError(f"need width > 0 and nb a positive multiple of "
                         f"{BLOCK}, got {width} / {nb}")
    if (gdata.ndim != 2 or gdata.shape[1] != GD_ROWS
            or gdata.shape[0] == 0 or gdata.shape[0] % nb):
        raise ValueError(f"gdata must be (n_pad, {GD_ROWS}) with n_pad a "
                         f"multiple of nb={nb}, got {tuple(gdata.shape)}")
    if not (lo.is_contiguous() and cnt.is_contiguous()
            and gdata.is_contiguous()):
        raise ValueError("lo, cnt and gdata must be contiguous")


def v2_fwd_plain(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                 hw_pad: int, width: int, nb: int) -> torch.Tensor:
    """K5's algorithm in torch (`_fwd_kernel_v2`, splat.py:452-483): per
    band, the exponents of its gaussian range at its 2048 pixels, then one
    f32 product with the featsop rows -> (8, hw_pad)."""
    _check(lo, cnt, gdata, hw_pad, width, nb)
    out = torch.zeros((FEAT_PAD, hw_pad), dtype=torch.float32,
                      device=gdata.device)
    for i, (l, c) in enumerate(zip(lo.tolist(), cnt.tolist())):
        if not c:
            continue
        gd = gdata[l * nb:(l + c) * nb]
        idx = i * TP2 + torch.arange(TP2, device=gdata.device)
        gx = (idx % width).float()[:, None] + 0.5              # (TP2, 1)
        gy = (idx // width).float()[:, None] + 0.5
        dx = gx - gd[None, :, 0]                               # (TP2, m)
        dy = gy - gd[None, :, 1]
        x = torch.exp(torch.clamp(
            dx * (gd[None, :, 2] * dx + gd[None, :, 3] * dy)
            + (gd[None, :, 4] * dy) * dy, min=EXP_FLOOR))
        out[:, i * TP2:(i + 1) * TP2] = (
            gd[:, GD_FEAT0:GD_FEAT0 + FEAT_PAD].T @ x.T)
    return out


def check_g8(g8, like: torch.Tensor, cols: int) -> None:
    """g8, a backward kernel's cotangent, must be contiguous float32
    (8, cols) on like's device."""
    if (g8.device != like.device or g8.dtype != torch.float32
            or tuple(g8.shape) != (FEAT_PAD, cols)
            or not g8.is_contiguous()):
        raise ValueError(f"g8 must be contiguous float32 ({FEAT_PAD}, "
                         f"{cols}) on {like.device}, got {g8.dtype} "
                         f"{tuple(g8.shape)} on {g8.device}")


def v2_bwd_plain(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                 g8: torch.Tensor, hw_pad: int, width: int,
                 nb: int) -> torch.Tensor:
    """K6's algorithm in torch (`_bwd_kernel_v2`, splat.py:510-569): per
    band, x over its gaussian range at its 2048 pixels, g_x = g8^T featsop
    and g_featop = g8 x as f32 products, the moments of g_e = x g_x; bands
    add into the (n_pad, 16) rows in band order."""
    _check(lo, cnt, gdata, hw_pad, width, nb)
    check_g8(g8, gdata, hw_pad)
    out = torch.zeros_like(gdata)
    for i, (l, c) in enumerate(zip(lo.tolist(), cnt.tolist())):
        if not c:
            continue
        s, e = l * nb, (l + c) * nb
        gd = gdata[s:e]
        idx = i * TP2 + torch.arange(TP2, device=gdata.device)
        gx = (idx % width).float()[:, None] + 0.5              # (TP2, 1)
        gy = (idx // width).float()[:, None] + 0.5
        dx = gx - gd[None, :, 0]                               # (TP2, m)
        dy = gy - gd[None, :, 1]
        x = torch.exp(torch.clamp(
            dx * (gd[None, :, 2] * dx + gd[None, :, 3] * dy)
            + (gd[None, :, 4] * dy) * dy, min=EXP_FLOOR))
        gb = g8[:, i * TP2:(i + 1) * TP2]                      # (8, TP2)
        g_e = x * (gb.T @ gd[:, GD_FEAT0:GD_FEAT0 + FEAT_PAD].T)
        u, v = g_e * dx, g_e * dy
        out[s:e, :5] += torch.stack([u.sum(0), v.sum(0), (u * dx).sum(0),
                                     (u * dy).sum(0), (v * dy).sum(0)], 1)
        out[s:e, GD_FEAT0:GD_FEAT0 + FEAT_PAD] += (gb @ x).T
    return out


def bwd_slices(n_pad: int, device: torch.device) -> int:
    """The pixel slices K6 splits each band into for n_pad gaussians on the
    CUDA device `device` (csrc/splat_v2_bwd.cu:pixel_slices, from n_pad and
    the device's SM count)."""
    with torch.cuda.device(device):
        slices = build.load("splat_v2_bwd").splat_v2_bwd_slices(n_pad)
    if slices < 1:
        raise RuntimeError(f"splat_v2_bwd: cannot read {device}'s SM count")
    return slices


@functools.lru_cache(maxsize=None)
def fwd_slices(n_bands: int, n_pad: int, device: torch.device) -> int:
    """The slices K5 splits each band's gaussian range into for these shapes
    on the CUDA device `device` (csrc/splat_v2_fwd.cu:band_slices, from
    n_bands, n_pad and the device's SM count). Host values only: no
    device-to-host copy."""
    with torch.cuda.device(device):
        slices = build.load("splat_v2_fwd").splat_v2_fwd_slices(n_bands,
                                                                n_pad)
    if slices < 1:
        raise RuntimeError(f"splat_v2_fwd: cannot read {device}'s SM count")
    return slices


def splat_v2_fwd(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                 hw_pad: int, width: int, nb: int) -> torch.Tensor:
    """K5 -> acc (8, hw_pad): the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    _check(lo, cnt, gdata, hw_pad, width, nb)
    if not build.on_cuda("splat_v2_fwd", gdata):
        return v2_fwd_plain(lo, cnt, gdata, hw_pad, width, nb)
    n_bands, n_pad = lo.shape[0], gdata.shape[0]
    slices = fwd_slices(n_bands, n_pad, gdata.device)
    out = torch.empty((FEAT_PAD, hw_pad), dtype=torch.float32,
                      device=gdata.device)
    # The slices' partial planes, which the kernel's second pass adds in
    # slice order; with one slice the kernel writes out itself.
    part = out if slices == 1 else torch.empty(
        (slices, FEAT_PAD, hw_pad), dtype=torch.float32, device=gdata.device)
    build.launch("splat_v2_fwd", (lo, cnt, gdata, part, out), n_bands, width,
                 nb, n_pad)
    launches["splat_v2_fwd"] += 1
    return out


def splat_v2_bwd(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                 g8: torch.Tensor, hw_pad: int, width: int,
                 nb: int) -> torch.Tensor:
    """K6 -> (n_pad, 16) per-gaussian moment rows: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    _check(lo, cnt, gdata, hw_pad, width, nb)
    check_g8(g8, gdata, hw_pad)
    if not build.on_cuda("splat_v2_bwd", gdata):
        return v2_bwd_plain(lo, cnt, gdata, g8, hw_pad, width, nb)
    n_pad = gdata.shape[0]
    slices = bwd_slices(n_pad, gdata.device)
    out = torch.empty_like(gdata)
    # The kernel's rows per pixel slice, summed in slice order by its second
    # pass; with one slice it writes out itself.
    part = out if slices == 1 else torch.empty(
        (slices, n_pad, GD_ROWS), dtype=torch.float32, device=gdata.device)
    build.launch("splat_v2_bwd", (lo, cnt, gdata, g8, part, out),
                 lo.shape[0], width, nb, n_pad)
    launches["splat_v2_bwd"] += 1
    return out

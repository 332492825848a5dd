"""Separable band accumulation (axis footprint): the CUDA kernels' wrappers
and their plain twins.

`splat_sep_fwd` launches `csrc/splat_sep_fwd.cu` (K1, the replacement of
the TPU kernel `tpu_gaussians/ops/pallas/splat.py:_fwd_kernel_sep`; its
product on the tensor cores, each band's gaussian range split into slices
whose partials a second pass adds in order, `fwd_slices`) and
`splat_sep_bwd` launches `csrc/splat_sep_bwd.cu` (K2, replacing
`_bwd_kernel_sep`; its two products on the tensor cores, each band's rows
and columns split into slices whose rows a second pass adds in order,
`bwd_slices`), for CUDA tensors; for CPU tensors each runs its plain twin,
the same banded algorithm in torch. Neither falls back from one to the
other.

Inputs shared by both:
  lo, cnt (n_bands,) int32: band i (image rows [i*R, (i+1)*R)) evaluates
      the gaussians of blocks [lo[i], lo[i] + cnt[i]) of nb gaussians;
  gdata (n_pad, 16) f32 row-major rows [px, py, a', b', c', op,
      featsop(8), 0, 0] with a' = -a/2, c' = -c/2 and featsop_f =
      feats_f * op (feats [r, g, b, 1, z, 0, 0, 0]).
With tx = x_c - px, ty = y_r - py (pixel centres at +0.5),
Ex[c] = exp(a' tx^2) and Ey[r] = exp(c' ty^2):
  K1 -> acc (n_bands, 5, R, Wp): acc[i, f, r, c] = sum_g featsop_f Ey[r] Ex[c]
  K2 takes gband (n_bands, 5, R, Wp), the cotangent of acc, and returns
     (n_pad, 16) rows [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop(8), 0, 0] summed
     over every band whose range holds the gaussian, where
       g_featop_f = sum_{r,c} gband[f,r,c] Ey[r] Ex[c],
       gEx[c] = sum_{f,r} gband[f,r,c] featsop_f Ey[r], u_x = gEx Ex,
       gEy[r] = sum_{f,c} gband[f,r,c] featsop_f Ex[c], u_y = gEy Ey,
       Mdx = sum_c u_x tx, Mxx = sum_c u_x tx^2, Mdy = sum_r u_y ty,
       Myy = sum_r u_y ty^2.
"""

from __future__ import annotations

import functools

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.ops.common import FEAT_DIM as FEAT  # r, g, b, 1, z

GD_ROWS = 16    # floats per gaussian row of gdata
GD_FEAT0 = 6    # featsop columns start
ROWS = (32, 64)  # band heights the kernels are built for
CHUNK = 64      # nb and wp divide by it: the kernels' 64-gaussian chunks
                # and 64-column strips (the staging, ops/splat._sep_dims,
                # gives multiples of 128)

launches = {"splat_sep_fwd": 0, "splat_sep_bwd": 0}   # kernel launches


def _check(lo, cnt, gdata, rows: int, wp: int, nb: int) -> None:
    if not (lo.device == cnt.device == gdata.device):
        raise ValueError(f"lo on {lo.device}, cnt on {cnt.device}, gdata on "
                         f"{gdata.device}")
    if lo.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise ValueError(f"lo and cnt must be int32, got {lo.dtype} / "
                         f"{cnt.dtype}")
    if gdata.dtype != torch.float32:
        raise ValueError(f"gdata must be float32, got {gdata.dtype}")
    if lo.ndim != 1 or lo.shape != cnt.shape or lo.shape[0] == 0:
        raise ValueError(f"lo and cnt must be (n_bands,), got "
                         f"{tuple(lo.shape)} / {tuple(cnt.shape)}")
    if rows not in ROWS:
        raise ValueError(f"band height must be one of {ROWS}, got {rows}")
    if wp <= 0 or wp % CHUNK or nb <= 0 or nb % CHUNK:
        raise ValueError(f"wp and nb must be positive multiples of {CHUNK}, "
                         f"got {wp} / {nb}")
    if (gdata.ndim != 2 or gdata.shape[1] != GD_ROWS
            or gdata.shape[0] == 0 or gdata.shape[0] % nb):
        raise ValueError(f"gdata must be (n_pad, {GD_ROWS}) with n_pad a "
                         f"multiple of nb={nb}, got {tuple(gdata.shape)}")
    if not (lo.is_contiguous() and cnt.is_contiguous()
            and gdata.is_contiguous()):
        raise ValueError("lo, cnt and gdata must be contiguous")


def _check_gband(gband, lo, rows: int, wp: int) -> None:
    shape = (lo.shape[0], FEAT, rows, wp)
    if gband.device != lo.device or gband.dtype != torch.float32:
        raise ValueError(f"gband must be float32 on {lo.device}, got "
                         f"{gband.dtype} on {gband.device}")
    if tuple(gband.shape) != shape or not gband.is_contiguous():
        raise ValueError(f"gband must be contiguous {shape}, got "
                         f"{tuple(gband.shape)}")


def _band_factors(gd: torch.Tensor, band: int, rows: int, wp: int):
    """The factor arrays of one band over gdata rows gd (m, 16):
    tx, Ex (wp, m); ty, Ey (R, m); featsop (5, m); G = featsop (x) Ey
    (5, R, m). The arithmetic of `_sep_factors` (splat.py:661-686)."""
    dev = gd.device
    xc = torch.arange(wp, device=dev, dtype=torch.int32).float() + 0.5
    yr = (band * rows + torch.arange(rows, device=dev, dtype=torch.int32)
          ).float() + 0.5
    tx = xc[:, None] - gd[None, :, 0]
    ex = torch.exp(gd[None, :, 2] * (tx * tx))
    ty = yr[:, None] - gd[None, :, 1]
    ey = torch.exp(gd[None, :, 4] * (ty * ty))
    featsop = gd[:, GD_FEAT0:GD_FEAT0 + FEAT].T
    return tx, ex, ty, ey, featsop, featsop[:, None, :] * ey[None]


def _ranges(lo, cnt, nb: int):
    return [(i, l * nb, (l + c) * nb)
            for i, (l, c) in enumerate(zip(lo.tolist(), cnt.tolist())) if c]


def sep_fwd_plain(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                  rows: int, wp: int, nb: int) -> torch.Tensor:
    """K1's algorithm in torch: per band, one f32 product of the (5R, m)
    factor G with Ex over the band's gaussian range -> (n_bands, 5, R, wp)."""
    _check(lo, cnt, gdata, rows, wp, nb)
    out = torch.zeros((lo.shape[0], FEAT, rows, wp), dtype=torch.float32,
                      device=gdata.device)
    for i, s, e in _ranges(lo, cnt, nb):
        _, ex, _, _, _, g_mat = _band_factors(gdata[s:e], i, rows, wp)
        out[i] = (g_mat.reshape(FEAT * rows, -1) @ ex.T).reshape(
            FEAT, rows, wp)
    return out


def sep_bwd_plain(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                  gband: torch.Tensor, rows: int, wp: int,
                  nb: int) -> torch.Tensor:
    """K2's algorithm in torch (`_bwd_kernel_sep`, splat.py:742-801): per
    band, gG = gband @ Ex and gEx = gband^T @ G, then the factor-chain
    moments; bands add into the (n_pad, 16) rows in band order."""
    _check(lo, cnt, gdata, rows, wp, nb)
    _check_gband(gband, lo, rows, wp)
    out = torch.zeros_like(gdata)
    for i, s, e in _ranges(lo, cnt, nb):
        tx, ex, ty, ey, featsop, g_mat = _band_factors(gdata[s:e], i, rows,
                                                       wp)
        gb = gband[i].reshape(FEAT * rows, wp)
        g_g = (gb @ ex).reshape(FEAT, rows, -1)
        g_ex = gb.T @ g_mat.reshape(FEAT * rows, -1)
        g_featop = (g_g * ey[None]).sum(dim=1)
        g_ey = (g_g * featsop[:, None, :]).sum(dim=0)
        t1 = g_ex * ex * tx
        t2 = g_ey * ey * ty
        out[s:e, 0] += t1.sum(dim=0)
        out[s:e, 1] += t2.sum(dim=0)
        out[s:e, 2] += (t1 * tx).sum(dim=0)
        out[s:e, 4] += (t2 * ty).sum(dim=0)
        out[s:e, GD_FEAT0:GD_FEAT0 + FEAT] += g_featop.T
    return out


def _launch(name: str, args, out: torch.Tensor, lo: torch.Tensor,
            rows: int, wp: int, nb: int) -> None:
    build.launch(name, (*args, out), lo.shape[0], rows, wp, nb,
                 args[2].shape[0])
    launches[name] += 1


@functools.lru_cache(maxsize=None)
def fwd_slices(n_bands: int, rows: int, wp: int, n_pad: int):
    """(slice length, slices) into which K1 splits each band's gaussian
    range for these shapes: the kernel's own rule, read from its library.
    Host values only: no device-to-host copy."""
    length = build.load("splat_sep_fwd").splat_sep_fwd_slice_len(
        n_bands, rows, wp, n_pad)
    return length, -(-n_pad // length)


@functools.lru_cache(maxsize=None)
def bwd_slices(rows: int, wp: int, n_pad: int) -> int:
    """The slices (32-row halves of a band times column ranges) into which
    K2 splits its work for these shapes: the kernel's own rule, read from
    its library. Host values only: no device-to-host copy."""
    return build.load("splat_sep_bwd").splat_sep_bwd_slices(rows, wp, n_pad)


def splat_sep_fwd(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                  rows: int, wp: int, nb: int) -> torch.Tensor:
    """K1 -> acc (n_bands, 5, R, wp): the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors."""
    _check(lo, cnt, gdata, rows, wp, nb)
    if not build.on_cuda("splat_sep_fwd", gdata):
        return sep_fwd_plain(lo, cnt, gdata, rows, wp, nb)
    shape = (lo.shape[0], FEAT, rows, wp)
    out = torch.empty(shape, dtype=torch.float32, device=gdata.device)
    # The slices' partials, which the kernel's second pass adds in slice
    # order; with one slice the kernel writes out itself.
    _, slices = fwd_slices(lo.shape[0], rows, wp, gdata.shape[0])
    part = out if slices == 1 else torch.empty(
        (slices, *shape), dtype=torch.float32, device=gdata.device)
    _launch("splat_sep_fwd", (lo, cnt, gdata, part), out, lo, rows, wp, nb)
    return out


def splat_sep_bwd(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                  gband: torch.Tensor, rows: int, wp: int,
                  nb: int) -> torch.Tensor:
    """K2 -> (n_pad, 16) per-gaussian moment rows: the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    _check(lo, cnt, gdata, rows, wp, nb)
    _check_gband(gband, lo, rows, wp)
    if not build.on_cuda("splat_sep_bwd", gdata, gband):
        return sep_bwd_plain(lo, cnt, gdata, gband, rows, wp, nb)
    out = torch.empty_like(gdata)
    # The slices' rows, which the kernel's second pass adds in slice order;
    # with one slice the kernel writes out itself.
    slices = bwd_slices(rows, wp, gdata.shape[0])
    part = out if slices == 1 else torch.empty(
        (slices, *gdata.shape), dtype=torch.float32, device=gdata.device)
    _launch("splat_sep_bwd", (lo, cnt, gdata, gband, part), out, lo, rows,
            wp, nb)
    return out


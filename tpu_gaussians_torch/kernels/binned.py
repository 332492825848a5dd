"""Tile-binned accumulation, forward and backward, for the general conic
(K8) and the separable axis footprint (K7): the CUDA kernels' wrappers and
their plain twins.

`binned_fwd` launches `csrc/binned_fwd.cu` (K8a, the replacement of the TPU
kernel `tpu_gaussians/ops/pallas/binned.py:_binned_fwd_kernel`; its product
on the tensor cores, each tile's slot list split into slices whose
partials a second pass adds in order, `fwd_slices`) and `binned_bwd`
launches `csrc/binned_bwd.cu` (K8b, replacing `_binned_bwd_kernel`; its
two products on the tensor cores, each tile's pixels split among a
block's warps when the shapes give few blocks, `bwd_pixel_slices`) for
CUDA tensors; for CPU tensors each runs its plain twin (`binned_fwd_plain`,
`binned_bwd_plain`), the TPU grid's algorithm in torch: per tile, per
512-slot chunk below the tile's count. Neither falls back from one to the
other.

Both take the per-tile slot lists row-major, gdense (n_tiles*cap, 16) f32
with rows [px, py, conic_a, conic_b, conic_c, op, feats(8), 0, 0] (the
layout of `ops/sorted.pack_gdata`, not JAX's transposed (16, S)), and cnt
(n_tiles,) int32. With dx = x - px, dy = y - py at pixel centres (+0.5)
and, with the conic unscaled and no cutoff,
  w = op exp(-0.5 (a dx^2 + 2 b dx dy + c dy^2)):
  K8a -> acc (8, n_tiles*2048): acc[f, p] = sum_s feats_f w, pixel l of
     tile t at column t*2048 + l (l = row*128 + col);
  K8b takes g8 (8, n_tiles*2048), the cotangent of acc, and returns raw
     (n_tiles*cap, 16) rows [Mdx, Mdy, Mxx, Mxy, Myy, M0, g_feat(8), 0, 0]:
     with g_e = w sum_f g8[f, p] feats_f, over the tile's pixels,
     M0 = sum g_e, Mdx = sum g_e dx, ..., Myy = sum g_e dy^2,
     g_feat_f = sum_p g8[f, p] w.
Chunk j of tile t is processed iff j*512 < cnt[t]; K8b's rows of other
chunks are zero. `ops/sorted.moment_postpass` turns the raw rows into
gradients of the gdense rows.

`binned_sep_fwd` launches `csrc/binned_sep_fwd.cu` (K7a, replacing
`_binned_fwd_kernel_sep`; its product on the tensor cores, each tile's
slot list split into slices as K8a's, `fwd_slices`) and `binned_sep_bwd`
launches `csrc/binned_sep_bwd.cu` (K7b, replacing
`_binned_bwd_kernel_sep`; its two products on the tensor cores, each
tile's columns split among a block's warps when the shapes give few
blocks, `bwd_col_slices`); their twins are `binned_sep_fwd_plain` and
`binned_sep_bwd_plain`. They take the
same gdense and cnt and read rows 0, 1, 2, 4, 5 and 6-13: conic b is 0 by
the axis contract, so w = op Ex(col) Ey(row) with, at column x and row y
of a tile, tx = x - px, ty = y - py,
  Ex = exp(-a/2 tx^2),  Ey = exp(-c/2 ty^2),  featsop_f = feats_f op:
  K7a -> acc (8, n_tiles*2048), as K8a: acc[f, p] = sum_s featsop_f Ey Ex;
  K7b takes g8 as K8b and returns raw rows [Mdx, Mdy, Mxx, 0, Myy, 0,
     g_featop(8), 0, 0]: with gG2[f, r] = sum_c g8[f, (r, c)] Ex[c] and
     gEx[c] = sum_(f, r) g8[f, (r, c)] featsop_f Ey[r] (the TPU kernel's
     two factor products), g_featop_f = sum_r gG2[f, r] Ey[r],
     gEy[r] = sum_f gG2[f, r] featsop_f, u_x = gEx Ex, u_y = gEy Ey,
     Mdx = sum_c u_x tx, Mxx = sum_c u_x tx^2, Mdy = sum_r u_y ty,
     Myy = sum_r u_y ty^2.
`ops/binned.moment_postpass_opfold` turns them into gradients of the
gdense rows.
"""

from __future__ import annotations

import functools

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.kernels.sorted_fwd import (
    FEAT_PAD, GD_ROWS, _check, tile_pixels)
from tpu_gaussians_torch.kernels.splat_v2 import EXP_FLOOR, check_g8
from tpu_gaussians_torch.ops.binning import NBS, TH, TPS, TWC

SUB = 128   # slots per sub-block of the twins (bounds their temporaries)

launches = {"binned_fwd": 0, "binned_bwd": 0,     # kernel launches
            "binned_sep_fwd": 0, "binned_sep_bwd": 0}


def _sub_blocks(cnt: torch.Tensor, cap: int):
    """(live tiles, first slot) of each SUB-slot sub-block of each chunk
    that some tile processes: chunk j of tile t iff j*NBS < cnt[t]."""
    for j in range(cap // NBS):
        live = torch.nonzero(j * NBS < cnt).flatten()
        if live.numel() == 0:
            break
        for lo in range(j * NBS, (j + 1) * NBS, SUB):
            yield live, lo


def _weights(gd: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """w, dx, dy (T, m, TPS) of slot rows gd (T, m, 16) at the tiles'
    pixels gx, gy (T, TPS), with the arithmetic of `_binned_fwd_kernel`
    (binned.py:146-155): no cutoff. The exponent is floored at EXP_FLOOR
    for the CPU's exp (see kernels/splat_v2.py)."""
    dx = gx[:, None, :] - gd[..., 0:1]
    dy = gy[:, None, :] - gd[..., 1:2]
    e = -0.5 * (gd[..., 2:3] * dx * dx + 2.0 * gd[..., 3:4] * dx * dy
                + gd[..., 4:5] * dy * dy)
    return gd[..., 5:6] * torch.exp(torch.clamp(e, min=EXP_FLOOR)), dx, dy


def binned_fwd_plain(gdense: torch.Tensor, cnt: torch.Tensor,
                     tiles_x: int) -> torch.Tensor:
    """K8a's algorithm in torch, vectorised over the tiles that process
    each chunk: per 128-slot sub-block, w and one f32 product with the
    feature rows added into the tiles' sums."""
    n_tiles, cap = _check(gdense, cnt)
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    gx, gy = tile_pixels(n_tiles, tiles_x, gdense.device)
    acc = torch.zeros((n_tiles, FEAT_PAD, TPS), dtype=torch.float32,
                      device=gdense.device)
    for live, lo in _sub_blocks(cnt, cap):
        gd = g[live, lo:lo + SUB]
        w, _, _ = _weights(gd, gx[live], gy[live])
        acc[live] += torch.einsum("tsf,tsp->tfp", gd[..., 6:6 + FEAT_PAD], w)
    return acc.permute(1, 0, 2).reshape(FEAT_PAD, n_tiles * TPS)


def binned_bwd_plain(gdense: torch.Tensor, cnt: torch.Tensor,
                     g8: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """K8b's algorithm in torch (`_binned_bwd_kernel`, binned.py:164-208):
    per 128-slot sub-block of the processed chunks, g_w = feats . g8 and
    g_feat = w g8 as f32 products, and the moments of g_e = w g_w."""
    n_tiles, cap = _check(gdense, cnt)
    check_g8(g8, gdense, n_tiles * TPS)
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    gx, gy = tile_pixels(n_tiles, tiles_x, gdense.device)
    g8t = g8.reshape(FEAT_PAD, n_tiles, TPS).permute(1, 0, 2)   # (T, 8, TPS)
    out = torch.zeros((n_tiles, cap, GD_ROWS), dtype=torch.float32,
                      device=gdense.device)
    for live, lo in _sub_blocks(cnt, cap):
        gd = g[live, lo:lo + SUB]
        gt = g8t[live]
        w, dx, dy = _weights(gd, gx[live], gy[live])
        g_e = w * torch.einsum("tsf,tfp->tsp", gd[..., 6:6 + FEAT_PAD], gt)
        u, v = g_e * dx, g_e * dy
        out[live, lo:lo + SUB, :6 + FEAT_PAD] = torch.cat([
            torch.stack([u.sum(2), v.sum(2), (u * dx).sum(2), (u * dy).sum(2),
                         (v * dy).sum(2), g_e.sum(2)], dim=2),
            torch.einsum("tsp,tfp->tsf", w, gt)], dim=2)
    return out.reshape(n_tiles * cap, GD_ROWS)


def _sep_factors(gd: torch.Tensor, xc: torch.Tensor, yr: torch.Tensor):
    """tx, Ex (T, m, 128), ty, Ey (T, m, 16) and featsop (T, m, 8) of slot
    rows gd (T, m, 16) at the tiles' column and row centres xc (T, 128)
    and yr (T, 16), with the arithmetic of `_sep_tile_factors`
    (binned.py:230-250); exponents floored at EXP_FLOOR for the CPU's exp
    (see kernels/splat_v2.py)."""
    tx = xc[:, None, :] - gd[..., 0:1]
    ex = torch.exp(torch.clamp(-0.5 * gd[..., 2:3] * (tx * tx),
                               min=EXP_FLOOR))
    ty = yr[:, None, :] - gd[..., 1:2]
    ey = torch.exp(torch.clamp(-0.5 * gd[..., 4:5] * (ty * ty),
                               min=EXP_FLOOR))
    return tx, ex, ty, ey, gd[..., 6:6 + FEAT_PAD] * gd[..., 5:6]


def _tile_axes(n_tiles: int, tiles_x: int, device):
    """Column centres xc (n_tiles, 128) and row centres yr (n_tiles, 16)."""
    gx, gy = tile_pixels(n_tiles, tiles_x, device)
    return gx[:, :TWC], gy[:, ::TWC]


def binned_sep_fwd_plain(gdense: torch.Tensor, cnt: torch.Tensor,
                         tiles_x: int) -> torch.Tensor:
    """K7a's algorithm in torch (`_binned_fwd_kernel_sep`, binned.py:
    258-274): per 128-slot sub-block of the processed chunks, the factors
    and one f32 product G2 (rows (f, r)) . Ex added into the tiles' sums."""
    n_tiles, cap = _check(gdense, cnt)
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    xc, yr = _tile_axes(n_tiles, tiles_x, gdense.device)
    acc = torch.zeros((n_tiles, FEAT_PAD * TH, TWC), dtype=torch.float32,
                      device=gdense.device)
    for live, lo in _sub_blocks(cnt, cap):
        _, ex, _, ey, fo = _sep_factors(g[live, lo:lo + SUB], xc[live],
                                        yr[live])
        g2 = (fo[..., :, None] * ey[..., None, :]).flatten(2)  # (T, m, 8*TH)
        acc[live] += torch.einsum("tsk,tsc->tkc", g2, ex)
    return acc.reshape(n_tiles, FEAT_PAD, TPS).permute(1, 0, 2).reshape(
        FEAT_PAD, n_tiles * TPS)


def binned_sep_bwd_plain(gdense: torch.Tensor, cnt: torch.Tensor,
                         g8: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """K7b's algorithm in torch (`_binned_bwd_kernel_sep`, binned.py:
    277-326): per 128-slot sub-block of the processed chunks, gG2 = gband .
    Ex and gEx = gband^T . G2 as f32 products, then g_featop, gEy and the
    four moments of u_x = gEx Ex and u_y = gEy Ey."""
    n_tiles, cap = _check(gdense, cnt)
    check_g8(g8, gdense, n_tiles * TPS)
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    xc, yr = _tile_axes(n_tiles, tiles_x, gdense.device)
    gband = g8.reshape(FEAT_PAD, n_tiles, TPS).permute(1, 0, 2).reshape(
        n_tiles, FEAT_PAD * TH, TWC)                # rows (f, r)
    out = torch.zeros((n_tiles, cap, GD_ROWS), dtype=torch.float32,
                      device=gdense.device)
    for live, lo in _sub_blocks(cnt, cap):
        tx, ex, ty, ey, fo = _sep_factors(g[live, lo:lo + SUB], xc[live],
                                          yr[live])
        gb = gband[live]
        g2 = (fo[..., :, None] * ey[..., None, :]).flatten(2)
        g_g2 = torch.einsum("tkc,tsc->tsk", gb, ex).unflatten(
            2, (FEAT_PAD, TH))                      # (T, m, 8, TH)
        g_ex = torch.einsum("tkc,tsk->tsc", gb, g2)  # (T, m, TWC)
        g_featop = (g_g2 * ey[..., None, :]).sum(3)
        g_ey = (g_g2 * fo[..., :, None]).sum(2)
        t1 = g_ex * ex * tx
        t2 = g_ey * ey * ty
        zero = torch.zeros_like(t1[..., 0])
        out[live, lo:lo + SUB, :6 + FEAT_PAD] = torch.cat([
            torch.stack([t1.sum(2), t2.sum(2), (t1 * tx).sum(2), zero,
                         (t2 * ty).sum(2), zero], dim=2), g_featop], dim=2)
    return out.reshape(n_tiles * cap, GD_ROWS)


def _launch(name: str, args, out: torch.Tensor, tiles_x: int, n_tiles: int,
            cap: int) -> None:
    build.launch(name, (*args, out), tiles_x, n_tiles, cap)
    launches[name] += 1


@functools.lru_cache(maxsize=None)
def fwd_slices(n_tiles: int, cap: int, name: str = "binned_fwd"):
    """(slice length, slices) into which forward kernel `name` (K8a, or
    K7a: "binned_sep_fwd") splits each tile's slot list for these shapes:
    the kernel's own rule, read from its library. Host values only: no
    device-to-host copy."""
    length = getattr(build.load(name), f"{name}_slice_len")(n_tiles, cap)
    return length, -(-cap // length)


@functools.lru_cache(maxsize=None)
def bwd_pixel_slices(n_tiles: int, cap: int) -> int:
    """The slices (1, 2 or 4) into which K8b splits each tile's pixels for
    these shapes, among the warps of a block that add their partials in
    order: the kernel's own rule, read from its library. Host values only:
    no device-to-host copy."""
    return build.load("binned_bwd").binned_bwd_pixel_slices(n_tiles, cap)


@functools.lru_cache(maxsize=None)
def bwd_col_slices(n_tiles: int, cap: int) -> int:
    """The column slices (1 or 2) into which K7b splits each tile for
    these shapes, among the warps of a block that add their partials in
    order: the kernel's own rule, read from its library. Host values only:
    no device-to-host copy."""
    return build.load("binned_sep_bwd").binned_sep_bwd_col_slices(n_tiles,
                                                                   cap)


def _sliced_fwd(name: str, gdense: torch.Tensor, cnt: torch.Tensor,
                tiles_x: int, n_tiles: int, cap: int) -> torch.Tensor:
    """Launch forward kernel `name` (K8a or K7a) -> acc (8, n_tiles*2048),
    with the scratch for its slices' partials, which the kernel's second
    pass adds in slice order; with one slice the kernel writes acc
    itself."""
    out = torch.empty((FEAT_PAD, n_tiles * TPS), dtype=torch.float32,
                      device=gdense.device)
    _, slices = fwd_slices(n_tiles, cap, name)
    part = out if slices == 1 else torch.empty(
        (slices, *out.shape), dtype=torch.float32, device=gdense.device)
    _launch(name, (gdense, cnt, part), out, tiles_x, n_tiles, cap)
    return out


def binned_fwd(gdense: torch.Tensor, cnt: torch.Tensor,
               tiles_x: int) -> torch.Tensor:
    """K8a -> acc (8, n_tiles*2048): the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    n_tiles, cap = _check(gdense, cnt)
    if not build.on_cuda("binned_fwd", gdense):
        return binned_fwd_plain(gdense, cnt, tiles_x)
    return _sliced_fwd("binned_fwd", gdense, cnt, tiles_x, n_tiles, cap)


def binned_bwd(gdense: torch.Tensor, cnt: torch.Tensor, g8: torch.Tensor,
               tiles_x: int) -> torch.Tensor:
    """K8b -> raw (n_tiles*cap, 16) moment rows: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    n_tiles, cap = _check(gdense, cnt)
    check_g8(g8, gdense, n_tiles * TPS)
    if not build.on_cuda("binned_bwd", gdense, g8):   # g8 by 16 B cp.async
        return binned_bwd_plain(gdense, cnt, g8, tiles_x)
    out = torch.empty_like(gdense)
    _launch("binned_bwd", (gdense, cnt, g8), out, tiles_x, n_tiles, cap)
    return out


def binned_sep_fwd(gdense: torch.Tensor, cnt: torch.Tensor,
                   tiles_x: int) -> torch.Tensor:
    """K7a -> acc (8, n_tiles*2048): the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    n_tiles, cap = _check(gdense, cnt)
    if not build.on_cuda("binned_sep_fwd", gdense):   # gdense by cp.async
        return binned_sep_fwd_plain(gdense, cnt, tiles_x)
    return _sliced_fwd("binned_sep_fwd", gdense, cnt, tiles_x, n_tiles, cap)


def binned_sep_bwd(gdense: torch.Tensor, cnt: torch.Tensor, g8: torch.Tensor,
                   tiles_x: int) -> torch.Tensor:
    """K7b -> raw (n_tiles*cap, 16) rows [Mdx, Mdy, Mxx, 0, Myy, 0,
    g_featop(8), 0, 0]: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    n_tiles, cap = _check(gdense, cnt)
    check_g8(g8, gdense, n_tiles * TPS)
    if not build.on_cuda("binned_sep_bwd", gdense, g8):   # g8 by float4
        return binned_sep_bwd_plain(gdense, cnt, g8, tiles_x)
    out = torch.empty_like(gdense)
    _launch("binned_sep_bwd", (gdense, cnt, g8), out, tiles_x, n_tiles, cap)
    return out

"""Backward of the per-tile depth-sorted compositing: the CUDA kernel's
wrapper and its plain twin.

`sorted_bwd` launches `csrc/sorted_bwd.cu` for CUDA tensors (the
replacement of the TPU kernel `tpu_gaussians/ops/pallas/sorted.py:
_sorted_bwd_kernel`) and runs `sorted_bwd_plain`, the TPU kernel's
algorithm in torch, for CPU tensors. It never falls back from one to the
other.

Both take the forward's inputs and outputs, gdense (n_tiles*cap, 16), cnt
(n_tiles,) int32, acc (8, n_tiles*2048) and chunks_done (n_tiles,) int32
(see kernels/sorted_fwd.py), and g8 (8, n_tiles*2048), the cotangent of
acc. For C = sum_i T_i a_i f_i per pixel and feature (T_i the
transmittance before slot i, a_i its clamped alpha) they recompute the
forward in slot order and return raw (n_tiles*cap, 16) rows

  [Mdx, Mdy, Mxx, Mxy, Myy, M0, g_feat(8), 0, 0]

with, summed over the tile's pixels,
  gf = f_i . g8,  P_i = sum_{j<=i} T_j a_j gf_j,  ctg = acc . g8,
  g_a = T_i gf - (ctg - P_i) / (1 - a_i),
  g_e = a_i g_a where 1e-5 <= a_raw <= 0.9999, else 0,
  M0 = sum g_e, Mdx = sum g_e dx, Mxx = sum g_e dx^2, likewise Mdy, Myy,
  Mxy = sum g_e dx dy (0 for the axis footprint), g_feat = sum T_i a_i g8.
A tile processes exactly the chunks_done chunks its forward composited;
the rows of other slots are zero. `ops/sorted.moment_postpass` turns the
moments into gradients of the slot rows.

The kernel walks a slot only in the warps (2 rows of 32 columns) where
K3's culling rule (`kernels/sorted_fwd.cull_blocks`) finds that its a_raw
can reach the cutoff; the others would add exact zeros. While a profiler
runs, `sorted_bwd` records one counter, `gs.composite.bwd.walks`: an
int64 (2,) device tensor of the walks its lists held and the walks of the
unculled kernel (composited slots x 32); `walk_counts` is its CPU mirror.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.kernels.sorted_fwd import (
    CLUSTER, FEAT_PAD, GD_ROWS, WARP_COLS, _check, clamp_alpha, cull_counts,
    exclusive_cumprod, slot_alpha, tile_pixels)
from tpu_gaussians_torch.ops.binning import A_MAX, ALPHA_CUTOFF, NBS, TH, TPS
from tpu_gaussians_torch.utils import profiling

launches = 0   # kernel launches made by sorted_bwd
WALK_PIXELS = (TH // CLUSTER) * WARP_COLS   # one warp's pixels of a tile


def _check_bwd(gdense, cnt, acc, g8, chunks_done):
    n_tiles, cap = _check(gdense, cnt)
    for name, t in (("acc", acc), ("g8", g8)):
        if (t.device != gdense.device or t.dtype != torch.float32
                or tuple(t.shape) != (FEAT_PAD, n_tiles * TPS)
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous float32 ({FEAT_PAD}, "
                f"{n_tiles * TPS}) on {gdense.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if (chunks_done.device != gdense.device
            or chunks_done.dtype != torch.int32
            or tuple(chunks_done.shape) != (n_tiles,)
            or not chunks_done.is_contiguous()):
        raise ValueError(f"chunks_done must be contiguous int32 ({n_tiles},)"
                         f" on {gdense.device}")
    return n_tiles, cap


def sorted_bwd_plain(gdense: torch.Tensor, cnt: torch.Tensor,
                     acc: torch.Tensor, g8: torch.Tensor,
                     chunks_done: torch.Tensor, tiles_x: int,
                     axis: bool = False) -> torch.Tensor:
    """The TPU kernel's algorithm in torch (sorted.py:1035-1150), vectorised
    over tiles: per 128-slot sub-block the exclusive cumprod of 1 - a_s
    gives T_i, the inclusive cumsum of contrib * gf gives P_i, and T drops
    by the sub-block's summed contributions. Tile t runs its first
    chunks_done[t] chunks."""
    n_tiles, cap = _check_bwd(gdense, cnt, acc, g8, chunks_done)
    dev = gdense.device
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    gx, gy = tile_pixels(n_tiles, tiles_x, dev)
    g8t = g8.reshape(FEAT_PAD, n_tiles, TPS).permute(1, 0, 2)   # (T, 8, TPS)
    ctg = (acc.reshape(FEAT_PAD, n_tiles, TPS).permute(1, 0, 2)
           * g8t).sum(dim=1)                                   # (T, TPS)
    trans = torch.ones((n_tiles, TPS), dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(trans)
    out = torch.zeros((n_tiles, cap, GD_ROWS), dtype=torch.float32,
                      device=dev)
    sub = NBS // 4
    for j in range(cap // NBS):
        upd = j < chunks_done
        if not bool(upd.any()):
            break
        for sb in range(4):
            lo = j * NBS + sb * sub
            gd = g[:, lo:lo + sub]                          # (T, sub, 16)
            a_raw, dx, dy = slot_alpha(gd, gx, gy, axis)
            a_s = clamp_alpha(a_raw)
            t_i = trans[:, None, :] * exclusive_cumprod(1.0 - a_s, dim=1)
            contrib = t_i * a_s
            gf = torch.einsum("tsf,tfp->tsp", gd[..., 6:6 + FEAT_PAD], g8t)
            up = prefix[:, None, :] + torch.cumsum(contrib * gf, dim=1)
            g_a = t_i * gf - (ctg[:, None, :] - up) / (1.0 - a_s)
            passed = (a_raw >= ALPHA_CUTOFF) & (a_raw <= A_MAX)
            g_e = torch.where(passed, a_s * g_a, torch.zeros_like(g_a))
            ux, vy = g_e * dx, g_e * dy
            mxy = (torch.zeros_like(ux[..., 0]) if axis
                   else (ux * dy).sum(dim=2))
            rows = torch.cat([
                torch.stack([ux.sum(dim=2), vy.sum(dim=2),
                             (ux * dx).sum(dim=2), mxy,
                             (vy * dy).sum(dim=2), g_e.sum(dim=2)], dim=2),
                torch.einsum("tsp,tfp->tsf", contrib, g8t)], dim=2)
            out[:, lo:lo + sub, :6 + FEAT_PAD] = torch.where(
                upd[:, None, None], rows, torch.zeros_like(rows))
            prefix = torch.where(upd[:, None], up[:, -1], prefix)
            trans = torch.where(upd[:, None], trans - contrib.sum(dim=1),
                                trans)
    return out.reshape(n_tiles * cap, GD_ROWS)


def walk_counts(gdense: torch.Tensor, cnt: torch.Tensor,
                chunks_done: torch.Tensor, tiles_x: int, axis: bool
                ) -> Tuple[int, int]:
    """The kernel's counter, by the culling rule's CPU mirror: (walked,
    slots), the (slot, block, warp) walks its lists hold over the
    composited slots (`cull_counts`' evaluated pairs, WALK_PIXELS each) and
    those of the unculled kernel, composited slots x 32."""
    c = cull_counts(gdense, cnt, chunks_done, tiles_x, axis)
    return (c["evaluated_pairs"] // WALK_PIXELS,
            c["composited_pairs"] // WALK_PIXELS)


def sorted_bwd(gdense: torch.Tensor, cnt: torch.Tensor, acc: torch.Tensor,
               g8: torch.Tensor, chunks_done: torch.Tensor, tiles_x: int,
               axis: bool = False) -> torch.Tensor:
    """raw (n_tiles*cap, 16) moment rows: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors. See the module docstring."""
    global launches
    n_tiles, cap = _check_bwd(gdense, cnt, acc, g8, chunks_done)
    if not build.on_cuda("sorted_bwd", gdense):
        return sorted_bwd_plain(gdense, cnt, acc, g8, chunks_done, tiles_x,
                                axis)
    out = torch.empty_like(gdense)
    walks = (torch.zeros(2, dtype=torch.int64, device=gdense.device)
             if profiling.active() else None)
    build.launch("sorted_bwd", (gdense, cnt, acc, g8, chunks_done, out,
                                walks), tiles_x, n_tiles, cap, int(axis))
    launches += 1
    if walks is not None:
        profiling.count("gs.composite.bwd.walks", walks)
    return out

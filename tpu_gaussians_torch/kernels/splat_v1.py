"""General-conic accumulation over a (pixel tile x gaussian block) grid,
forward and backward: the CUDA kernels' wrappers and their plain twins.

`splat_v1_fwd` launches `csrc/splat_v1_fwd.cu` (K9a, the replacement of
the TPU kernel `tpu_gaussians/ops/pallas/splat.py:_fwd_kernel`) and
`splat_v1_bwd` launches `csrc/splat_v1_bwd.cu` (K9b, replacing
`_bwd_kernel`) for CUDA tensors; for CPU tensors each runs its plain twin
(`v1_fwd_plain`, `v1_bwd_plain`), the TPU grid's algorithm in torch.
Neither falls back from one to the other. JAX takes this route for the
EWA footprint above the sizes at which its band kernels' data fit the
TPU's VMEM (`ops/splat._choose_v2`).

Inputs:
  mask (n_tiles, n_blocks) uint8: block j (gaussians [j*nb, (j+1)*nb))
      contributes to tile i (pixels [i*tp, (i+1)*tp) of the row-major
      frame, padded to hw_pad = n_tiles*tp) iff mask[i, j] != 0;
  gdata (n_pad, 16) f32 row-major rows [px, py, a, b, c, op, feats(8), 0,
      0]: the conic unscaled, feats not multiplied by op (the layout of
      `ops/sorted.pack_gdata`, without its dead row).
With dx = x - px, dy = y - py at pixel centres (+0.5),
  w = op exp(-0.5 (a dx^2 + 2 b dx dy + c dy^2)):
  K9a -> acc (8, hw_pad): acc[f, p] = sum_g feats_f w;
  K9b takes g8 (8, hw_pad), the cotangent of acc, and returns gradients
     (n_pad, 16) [g_px, g_py, g_a, g_b, g_c, g_op, g_feat(8), 0, 0] summed
     over the tiles whose mask holds the gaussian's block: with
     g_w = sum_f g8[f, p] feats_f and g_e = w g_w,
     g_px = sum g_e (a dx + b dy), g_py = sum g_e (b dx + c dy),
     g_a = -sum g_e dx^2 / 2, g_b = -sum g_e dx dy, g_c = -sum g_e dy^2 / 2,
     g_op = sum exp(e) g_w, g_feat_f = sum_p g8[f, p] w. No post-pass.
"""

from __future__ import annotations

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.kernels.splat_sep import GD_FEAT0, GD_ROWS
from tpu_gaussians_torch.kernels.splat_v2 import EXP_FLOOR, check_g8

FEAT_PAD = 8    # output rows
BLOCK = 128     # nb and tp are multiples of this (ops/splat._tile_sizes)
SUB_BLOCKS = 8  # gaussian blocks per product in the twins (bounds temps)

launches = {"splat_v1_fwd": 0, "splat_v1_bwd": 0}   # kernel launches


def _check(mask, gdata, hw_pad: int, width: int, nb: int, tp: int) -> None:
    if mask.device != gdata.device:
        raise ValueError(f"mask on {mask.device}, gdata on {gdata.device}")
    if mask.dtype != torch.uint8 or gdata.dtype != torch.float32:
        raise ValueError(f"need mask uint8 and gdata float32, got "
                         f"{mask.dtype} / {gdata.dtype}")
    if width <= 0 or nb <= 0 or nb % BLOCK or tp <= 0 or tp % BLOCK:
        raise ValueError(f"need width > 0 and nb, tp positive multiples of "
                         f"{BLOCK}, got {width} / {nb} / {tp}")
    if (gdata.ndim != 2 or gdata.shape[1] != GD_ROWS
            or gdata.shape[0] == 0 or gdata.shape[0] % nb):
        raise ValueError(f"gdata must be (n_pad, {GD_ROWS}) with n_pad a "
                         f"multiple of nb={nb}, got {tuple(gdata.shape)}")
    if (mask.ndim != 2 or mask.shape[0] * tp != hw_pad
            or mask.shape[1] * nb != gdata.shape[0]):
        raise ValueError(f"mask must be (hw_pad / tp, n_pad / nb) = "
                         f"({hw_pad // tp}, {gdata.shape[0] // nb}), got "
                         f"{tuple(mask.shape)}")
    if not (mask.is_contiguous() and gdata.is_contiguous()):
        raise ValueError("mask and gdata must be contiguous")


def _tile_weights(gd: torch.Tensor, i: int, width: int, tp: int):
    """exp(e), w, dx, dy (m, tp) of gaussian rows gd (m, 16) at tile i's
    pixels, with the arithmetic of `_fwd_kernel` (splat.py:209-216); the
    exponent floored at EXP_FLOOR for the CPU's exp."""
    idx = i * tp + torch.arange(tp, device=gd.device)
    gx = (idx % width).float()[None, :] + 0.5
    gy = (idx // width).float()[None, :] + 0.5
    dx = gx - gd[:, 0:1]
    dy = gy - gd[:, 1:2]
    e = -0.5 * (gd[:, 2:3] * dx * dx + 2.0 * gd[:, 3:4] * dx * dy
                + gd[:, 4:5] * dy * dy)
    ex = torch.exp(torch.clamp(e, min=EXP_FLOOR))
    return ex, gd[:, 5:6] * ex, dx, dy


def _tile_groups(mask: torch.Tensor, nb: int):
    """(tile, blocks) of each group of up to SUB_BLOCKS active blocks of
    each tile: tiles in order, and each tile's active blocks in order."""
    for i in range(mask.shape[0]):
        active = torch.nonzero(mask[i]).flatten().tolist()
        for k in range(0, len(active), SUB_BLOCKS):
            yield i, active[k:k + SUB_BLOCKS]


def _rows(blocks, nb: int, device) -> torch.Tensor:
    """The gdata rows of `blocks`, in order."""
    return (torch.tensor(blocks, device=device)[:, None] * nb
            + torch.arange(nb, device=device)).flatten()


def v1_fwd_plain(mask: torch.Tensor, gdata: torch.Tensor, hw_pad: int,
                 width: int, nb: int, tp: int) -> torch.Tensor:
    """K9a's algorithm in torch (`_fwd_kernel`, splat.py:196-224): per tile,
    its active blocks in order, w and one f32 product with the feature
    rows added into the tile's sums."""
    _check(mask, gdata, hw_pad, width, nb, tp)
    out = torch.zeros((FEAT_PAD, hw_pad), dtype=torch.float32,
                      device=gdata.device)
    for i, blocks in _tile_groups(mask, nb):
        gd = gdata[_rows(blocks, nb, gdata.device)]
        _, w, _, _ = _tile_weights(gd, i, width, tp)
        out[:, i * tp:(i + 1) * tp] += (
            gd[:, GD_FEAT0:GD_FEAT0 + FEAT_PAD].T @ w)
    return out


def v1_bwd_plain(mask: torch.Tensor, gdata: torch.Tensor, g8: torch.Tensor,
                 hw_pad: int, width: int, nb: int, tp: int) -> torch.Tensor:
    """K9b's algorithm in torch (`_bwd_kernel`, splat.py:850-907): per tile
    in order, its active blocks' gradient columns from g_w = feats . g8
    and g_feat = w . g8^T as f32 products, added into the blocks' rows, so
    each block sums its tiles in tile order."""
    _check(mask, gdata, hw_pad, width, nb, tp)
    check_g8(g8, gdata, hw_pad)
    out = torch.zeros_like(gdata)
    for i, blocks in _tile_groups(mask, nb):
        rows = _rows(blocks, nb, gdata.device)
        gd = gdata[rows]
        ca, cb, cc = gd[:, 2:3], gd[:, 3:4], gd[:, 4:5]
        ex, w, dx, dy = _tile_weights(gd, i, width, tp)
        gb = g8[:, i * tp:(i + 1) * tp]                   # (8, tp)
        g_w = gd[:, GD_FEAT0:GD_FEAT0 + FEAT_PAD] @ gb    # (m, tp)
        g_e = w * g_w
        out[rows, :6 + FEAT_PAD] += torch.cat([torch.stack([
            (g_e * (ca * dx + cb * dy)).sum(1),
            (g_e * (cb * dx + cc * dy)).sum(1),
            (g_e * -0.5 * dx * dx).sum(1),
            (g_e * -1.0 * dx * dy).sum(1),
            (g_e * -0.5 * dy * dy).sum(1),
            (ex * g_w).sum(1)], dim=1), w @ gb.T], dim=1)
    return out


def splat_v1_fwd(mask: torch.Tensor, gdata: torch.Tensor, hw_pad: int,
                 width: int, nb: int, tp: int) -> torch.Tensor:
    """K9a -> acc (8, hw_pad): the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    _check(mask, gdata, hw_pad, width, nb, tp)
    if not build.on_cuda("splat_v1_fwd", gdata):
        return v1_fwd_plain(mask, gdata, hw_pad, width, nb, tp)
    out = torch.empty((FEAT_PAD, hw_pad), dtype=torch.float32,
                      device=gdata.device)
    build.launch("splat_v1_fwd", (mask, gdata, out), mask.shape[0],
                 mask.shape[1], width, nb, tp)
    launches["splat_v1_fwd"] += 1
    return out


def splat_v1_bwd(mask: torch.Tensor, gdata: torch.Tensor, g8: torch.Tensor,
                 hw_pad: int, width: int, nb: int, tp: int) -> torch.Tensor:
    """K9b -> (n_pad, 16) per-gaussian gradient rows: the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    _check(mask, gdata, hw_pad, width, nb, tp)
    check_g8(g8, gdata, hw_pad)
    if not build.on_cuda("splat_v1_bwd", gdata, g8):   # g8 by 16 B cp.async
        return v1_bwd_plain(mask, gdata, g8, hw_pad, width, nb, tp)
    out = torch.empty_like(gdata)
    build.launch("splat_v1_bwd", (mask, gdata, g8, out), mask.shape[0],
                 mask.shape[1], width, nb, tp)
    launches["splat_v1_bwd"] += 1
    return out

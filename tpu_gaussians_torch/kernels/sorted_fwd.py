"""Per-tile depth-sorted compositing: the CUDA kernel's wrapper and its
plain twin.

`sorted_tiles` launches `csrc/sorted_fwd.cu` for CUDA tensors (the
replacement of the TPU kernel `tpu_gaussians/ops/pallas/sorted.py:
_sorted_kernel`) and runs `sorted_tiles_plain`, the same tiled algorithm in
torch, for CPU tensors. It never falls back from one to the other.

Both take the per-tile slot lists row-major, gdense (n_tiles*cap, 16) f32
with rows [px, py, conic_a, conic_b, conic_c, op, r, g, b, 1, z, 0...], and
cnt (n_tiles,) int32, and return
  acc (8, n_tiles*2048) f32: rows [r, g, b, 1 - T_final, sum contrib*z,
      0, 0, 0] per tile pixel (pixel l of tile t at column t*2048 + l,
      l = row*128 + col), the layout of the TPU kernel's output;
  chunks_done (n_tiles,) int32: the 512-slot chunks each tile composited
      before the whole-tile early exit.

The kernel culls (slot, pixel) pairs where a_raw cannot reach the 1e-5
cutoff, which leaves its output as it was. `slot_extent` and `cull_blocks`
are its rule in torch, for the tests and for `cull_counts`, which counts
the pairs a launch composites, needs (live) and evaluates.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.ops.binning import (
    A_MAX, ALPHA_CUTOFF, EXIT_T, NBS, TH, TPS, TWC)

GD_ROWS = 16   # floats per slot row
FEAT_PAD = 8   # output rows
EXP_FLOOR = -30.0   # the twins' exponent floor (see slot_alpha)
CLUSTER = 8         # the kernel's blocks per tile: TH // CLUSTER rows each
WARP_COLS = 32      # the columns of one of a block's warps
# The culling rule's slack (csrc/sorted_fwd.cu): Q = Q_SCALE (2 ln(op /
# 1e-5) + Q_SLACK), the extent's half-widths sqrt(Q c / det) and sqrt(Q a /
# det) plus MARGIN_PX, and conics with det < MIN_DET_RATIO a c never culled.
Q_SLACK = 1e-4
Q_SCALE = 1.01
MIN_DET_RATIO = 2e-3
MARGIN_PX = 1.0

launches = 0   # kernel launches made by sorted_tiles


def _check(gdense: torch.Tensor, cnt: torch.Tensor) -> Tuple[int, int]:
    if gdense.device != cnt.device:
        raise ValueError(f"gdense on {gdense.device}, cnt on {cnt.device}")
    if gdense.dtype != torch.float32 or cnt.dtype != torch.int32:
        raise ValueError(f"need gdense float32 and cnt int32, got "
                         f"{gdense.dtype} / {cnt.dtype}")
    if cnt.ndim != 1 or cnt.shape[0] == 0:
        raise ValueError(f"cnt must be (n_tiles,), got {tuple(cnt.shape)}")
    n_tiles = cnt.shape[0]
    if (gdense.ndim != 2 or gdense.shape[1] != GD_ROWS
            or gdense.shape[0] % (n_tiles * NBS)):
        raise ValueError(
            f"gdense must be (n_tiles*cap, {GD_ROWS}) with cap a multiple of "
            f"{NBS}, got {tuple(gdense.shape)} for {n_tiles} tiles")
    if not (gdense.is_contiguous() and cnt.is_contiguous()):
        raise ValueError("gdense and cnt must be contiguous")
    return n_tiles, gdense.shape[0] // n_tiles


def tile_pixels(n_tiles: int, tiles_x: int, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres gx, gy (n_tiles, TPS) of every tile; pixel l of a tile
    is at row l // 128, column l % 128."""
    tile = torch.arange(n_tiles, device=device)[:, None]
    pix = torch.arange(TPS, device=device)[None, :]
    gx = ((tile % tiles_x) * TWC + pix % TWC).float() + 0.5
    gy = ((tile // tiles_x) * TH + pix // TWC).float() + 0.5
    return gx, gy


def slot_alpha(gd: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
               axis: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw alpha of slot rows gd (T, m, 16) at the tiles' pixels, with the
    arithmetic of `_sorted_kernel` (sorted.py:261-269; the axis footprint
    in `_a_raw_sep`'s factorised form, :206-218) -> (a_raw, dx, dy), each
    (T, m, TPS).

    Exponents are floored at EXP_FLOOR: torch's CPU exp takes a slow path
    below about -87, where most far (slot, pixel) pairs lie, and with op
    <= 1 any alpha that the floor touches (< 9.4e-14) is under the 1e-5
    cutoff with or without it, so no clamped alpha changes."""
    dx = gx[:, None, :] - gd[..., 0:1]
    dy = gy[:, None, :] - gd[..., 1:2]

    def exp(e):
        return torch.exp(torch.clamp(e, min=EXP_FLOOR))

    if axis:
        txd, tyd = dx[..., :TWC], dy[..., ::TWC]   # (T, m, TWC), (T, m, TH)
        exf = exp(-0.5 * gd[..., 2:3] * (txd * txd))
        eyop = gd[..., 5:6] * exp(-0.5 * gd[..., 4:5] * (tyd * tyd))
        a_raw = (eyop[..., :, None] * exf[..., None, :]).reshape(dx.shape)
    else:
        e = -0.5 * (gd[..., 2:3] * dx * dx + 2.0 * gd[..., 3:4] * dx * dy
                    + gd[..., 4:5] * dy * dy)
        a_raw = gd[..., 5:6] * exp(e)
    return a_raw, dx, dy


def clamp_alpha(a_raw: torch.Tensor) -> torch.Tensor:
    """a_s: 0 below ALPHA_CUTOFF, else a_raw clamped to A_MAX."""
    return torch.where(a_raw < ALPHA_CUTOFF, torch.zeros_like(a_raw),
                       torch.clamp(a_raw, 0.0, A_MAX))


def exclusive_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index i gets prod(x[0..i-1]) along `dim`; index 0 gets 1."""
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cat([ones, torch.cumprod(x, dim=dim).narrow(
        dim, 0, x.shape[dim] - 1)], dim=dim)


def slot_extent(gd: torch.Tensor, axis: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's culling rule for slot rows gd (..., 16) -> half-widths
    (ex, ey), each (...): every pixel where the slot's a_raw can reach
    ALPHA_CUTOFF has |gx - px| <= ex and |gy - py| <= ey. With Q = Q_SCALE
    (2 ln(op / 1e-5) + Q_SLACK) and det = a c - b^2 (b = 0 for the axis
    footprint), ex = sqrt(Q c / det) + 1 and ey = sqrt(Q a / det) + 1; the
    slack covers the f32 rounding of the exponent, the exp and the product
    while det >= MIN_DET_RATIO a c. -inf where no pixel can reach the
    cutoff (op <= 0 or Q <= 0); +inf where the slot is never culled: a
    conic that is not positive definite or is thinner than that, or a
    non-finite value among px, py, a, b, c, op."""
    px, py, a, c, op = (gd[..., k] for k in (0, 1, 2, 4, 5))
    b = torch.zeros_like(a) if axis else gd[..., 3]
    ac = a * c
    det = ac - b * b
    finite = torch.ones_like(a, dtype=torch.bool)
    for v in (px, py, a, b, c, op, ac):
        finite &= torch.isfinite(v)
    cullable = (finite & (a > 0) & (c > 0) & (det > 0)
                & (det >= MIN_DET_RATIO * ac))
    pos = op > 0
    q = torch.where(pos, 2.0 * torch.log(torch.where(pos, op, 1.0)
                                         / ALPHA_CUTOFF) + Q_SLACK, -1.0)
    touches = q > 0
    safe = cullable & touches
    qe = q * Q_SCALE
    det_s = torch.where(safe, det, 1.0)
    inf = torch.full_like(a, float("inf"))
    out = []
    for num in (c, a):
        half = torch.sqrt(torch.where(safe, qe * num / det_s, 0.0)) + MARGIN_PX
        out.append(torch.where(cullable, torch.where(touches, half, -inf),
                               inf))
    return out[0], out[1]


def cull_blocks(gd: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                axis: bool) -> torch.Tensor:
    """(T, m, CLUSTER, TWC // WARP_COLS) bool: whether the kernel's block r
    (tile rows r*PPT ... r*PPT + PPT - 1, PPT = TH // CLUSTER) and its warp
    w (columns w*32 ... w*32 + 31) evaluate slot rows gd (T, m, 16) of
    tiles whose first column and row are x0, y0 (T,) -- the kernel's
    comparisons of the extents with its rows' and columns' pixel
    centres."""
    ex, ey = slot_extent(gd, axis)
    never = torch.isinf(ex) & (ex > 0)
    px, py = gd[..., 0, None], gd[..., 1, None]
    ppt = TH // CLUSTER
    dev = gd.device
    rows = torch.arange(CLUSTER, device=dev) * ppt
    ylo = (y0[:, None] + rows[None, :]).float() + 0.5          # (T, CLUSTER)
    yhi = (y0[:, None] + rows[None, :] + ppt - 1).float() + 0.5
    cols = torch.arange(TWC // WARP_COLS, device=dev) * WARP_COLS
    xl = (x0[:, None] + cols[None, :]).float() + 0.5            # (T, WARPS)
    xh = (x0[:, None] + cols[None, :] + WARP_COLS - 1).float() + 0.5
    ey, ex = ey[..., None], ex[..., None]
    y_ok = (py - ey <= yhi[:, None, :]) & (py + ey >= ylo[:, None, :])
    x_ok = (px - ex <= xh[:, None, :]) & (px + ex >= xl[:, None, :])
    both = y_ok[..., :, None] & x_ok[..., None, :]
    return both | never[..., None, None]


def cull_counts(gdense: torch.Tensor, cnt: torch.Tensor,
                chunks_done: torch.Tensor, tiles_x: int, axis: bool,
                tiles_per_batch: int = 16) -> dict:
    """The (slot, pixel) pairs of one launch over the slots its tiles
    composited (the first min(cnt, 512 chunks_done) of each list):
    composited_pairs, all of them; live_pairs, those with slot_alpha's
    a_raw >= ALPHA_CUTOFF; evaluated_pairs, those the kernel's culling
    rule leaves (cull_blocks). Batches of tiles bound the memory."""
    n_tiles, cap = _check(gdense, cnt)
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    limit = torch.minimum(cnt.to(torch.int64),
                          chunks_done.to(torch.int64) * NBS)
    gx, gy = tile_pixels(n_tiles, tiles_x, gdense.device)
    tile = torch.arange(n_tiles, device=gdense.device)
    x0, y0 = (tile % tiles_x) * TWC, (tile // tiles_x) * TH
    live = evaluated = 0
    sub = NBS // 4
    for t0 in range(0, n_tiles, tiles_per_batch):
        t1 = min(t0 + tiles_per_batch, n_tiles)
        top = int(limit[t0:t1].max())
        for lo in range(0, top, sub):
            gd = g[t0:t1, lo:lo + sub]
            used = (torch.arange(lo, lo + gd.shape[1], device=gd.device)[
                None, :] < limit[t0:t1, None])                 # (T, m)
            a_raw = slot_alpha(gd, gx[t0:t1], gy[t0:t1], axis)[0]
            live += int(((a_raw >= ALPHA_CUTOFF) & used[..., None]).sum())
            blocks = cull_blocks(gd, x0[t0:t1], y0[t0:t1], axis)
            evaluated += int((blocks & used[..., None, None]).sum())
    per_block_warp = (TH // CLUSTER) * WARP_COLS
    return {"composited_pairs": int(limit.sum()) * TPS,
            "live_pairs": live, "evaluated_pairs": evaluated * per_block_warp}


def sorted_tiles_plain(gdense: torch.Tensor, cnt: torch.Tensor, tiles_x: int,
                       axis: bool = False, exit_t: float = EXIT_T
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's algorithm in torch, vectorised over tiles, one
    512-slot chunk at a time (sorted.py:232-291): per 128-slot sub-block,
    a_s (alpha after cutoff and clamp), its exclusive cumprod of 1 - a_s,
    the contributions, rgbw += T * block and T *= 1 - block[3]; a tile
    composites chunk j only while j*512 < cnt and its max T > exit_t."""
    n_tiles, cap = _check(gdense, cnt)
    dev = gdense.device
    g = gdense.reshape(n_tiles, cap, GD_ROWS)
    gx, gy = tile_pixels(n_tiles, tiles_x, dev)

    rgbw = torch.zeros((n_tiles, FEAT_PAD, TPS), dtype=torch.float32,
                       device=dev)
    trans = torch.ones((n_tiles, TPS), dtype=torch.float32, device=dev)
    chunks = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    sub = NBS // 4
    for j in range(cap // NBS):
        upd = (j * NBS < cnt) & (trans.amax(dim=1) > exit_t)
        if not bool(upd.any()):     # no tile composites this chunk or later
            break
        rg, tr = rgbw, trans
        for sb in range(4):
            lo = j * NBS + sb * sub
            gd = g[:, lo:lo + sub]                          # (T, sub, 16)
            a_s = clamp_alpha(slot_alpha(gd, gx, gy, axis)[0])
            t_excl = exclusive_cumprod(1.0 - a_s, dim=1)
            block = torch.einsum("tsf,tsp->tfp", gd[..., 6:6 + FEAT_PAD],
                                 t_excl * a_s)              # (T, 8, TPS)
            rg = rg + tr[:, None, :] * block
            tr = tr * (1.0 - block[:, 3, :])
        rgbw = torch.where(upd[:, None, None], rg, rgbw)
        trans = torch.where(upd[:, None], tr, trans)
        chunks += upd.to(torch.int32)
    rgbw[:, 3] = 1.0 - trans
    return rgbw.permute(1, 0, 2).reshape(FEAT_PAD, n_tiles * TPS), chunks


def sorted_tiles(gdense: torch.Tensor, cnt: torch.Tensor, tiles_x: int,
                 axis: bool = False, exit_t: float = EXIT_T
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite the per-tile lists: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors. See the module docstring for the layouts."""
    global launches
    n_tiles, cap = _check(gdense, cnt)
    if not build.on_cuda("sorted_tiles", gdense):
        return sorted_tiles_plain(gdense, cnt, tiles_x, axis, exit_t)
    out = torch.empty((FEAT_PAD, n_tiles * TPS), dtype=torch.float32,
                      device=gdense.device)
    chunks = torch.empty((n_tiles,), dtype=torch.int32, device=gdense.device)
    build.launch("sorted_fwd", (gdense, cnt, out, chunks), tiles_x, n_tiles,
                 cap, float(exit_t), int(axis))
    launches += 1
    return out, chunks

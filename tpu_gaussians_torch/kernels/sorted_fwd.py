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
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.ops.binning import (
    A_MAX, ALPHA_CUTOFF, EXIT_T, NBS, TH, TPS, TWC)

GD_ROWS = 16   # floats per slot row
FEAT_PAD = 8   # output rows

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
    tile = torch.arange(n_tiles, device=dev)
    tx = (tile % tiles_x)[:, None]
    ty = (tile // tiles_x)[:, None]
    pix = torch.arange(TPS, device=dev)[None, :]
    if axis:
        xc = (tx * TWC + torch.arange(TWC, device=dev)).float() + 0.5
        yr = (ty * TH + torch.arange(TH, device=dev)).float() + 0.5
    else:
        gx = (tx * TWC + pix % TWC).float() + 0.5          # (T, TPS)
        gy = (ty * TH + pix // TWC).float() + 0.5

    rgbw = torch.zeros((n_tiles, FEAT_PAD, TPS), dtype=torch.float32,
                       device=dev)
    trans = torch.ones((n_tiles, TPS), dtype=torch.float32, device=dev)
    chunks = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    sub = NBS // 4
    for j in range(cap // NBS):
        upd = (j * NBS < cnt) & (trans.amax(dim=1) > exit_t)
        rg, tr = rgbw, trans
        for sb in range(4):
            lo = j * NBS + sb * sub
            gd = g[:, lo:lo + sub]                          # (T, sub, 16)
            if axis:
                txd = xc[:, None, :] - gd[..., 0:1]         # (T, sub, TWC)
                exf = torch.exp(-0.5 * gd[..., 2:3] * (txd * txd))
                tyd = yr[:, None, :] - gd[..., 1:2]         # (T, sub, TH)
                eyop = gd[..., 5:6] * torch.exp(-0.5 * gd[..., 4:5]
                                                * (tyd * tyd))
                a_raw = (eyop[..., :, None] * exf[..., None, :]).reshape(
                    n_tiles, sub, TPS)
            else:
                dx = gx[:, None, :] - gd[..., 0:1]          # (T, sub, TPS)
                dy = gy[:, None, :] - gd[..., 1:2]
                e = -0.5 * (gd[..., 2:3] * dx * dx
                            + 2.0 * gd[..., 3:4] * dx * dy
                            + gd[..., 4:5] * dy * dy)
                a_raw = gd[..., 5:6] * torch.exp(e)
            a_s = torch.where(a_raw < ALPHA_CUTOFF, torch.zeros_like(a_raw),
                              torch.clamp(a_raw, 0.0, A_MAX))
            t_excl = torch.cat([torch.ones_like(a_s[:, :1]),
                                torch.cumprod(1.0 - a_s, dim=1)[:, :-1]],
                               dim=1)
            block = torch.einsum("tsf,tsp->tfp", gd[..., 6:6 + FEAT_PAD],
                                 t_excl * a_s)              # (T, 8, TPS)
            rg = rg + tr[:, None, :] * block
            tr = tr * (1.0 - block[:, 3, :])
        rgbw = torch.where(upd[:, None, None], rg, rgbw)
        trans = torch.where(upd[:, None], tr, trans)
        chunks += upd.to(torch.int32)
    rgbw[:, 3] = 1.0 - trans
    return rgbw.permute(1, 0, 2).reshape(FEAT_PAD, n_tiles * TPS), chunks


def _library() -> ctypes.CDLL:
    lib = build.load("sorted_fwd")
    fn = lib.sorted_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def sorted_tiles(gdense: torch.Tensor, cnt: torch.Tensor, tiles_x: int,
                 axis: bool = False, exit_t: float = EXIT_T
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite the per-tile lists: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors. See the module docstring for the layouts."""
    global launches
    n_tiles, cap = _check(gdense, cnt)
    if gdense.device.type == "cpu":
        return sorted_tiles_plain(gdense, cnt, tiles_x, axis, exit_t)
    if gdense.device.type != "cuda":
        raise ValueError(f"sorted_tiles runs on cuda or cpu, got {gdense.device}")
    if gdense.data_ptr() % 16:
        raise ValueError("gdense must be 16-byte aligned (the kernel loads float4)")
    fn = _library().sorted_fwd_launch
    out = torch.empty((FEAT_PAD, n_tiles * TPS), dtype=torch.float32,
                      device=gdense.device)
    chunks = torch.empty((n_tiles,), dtype=torch.int32, device=gdense.device)
    with torch.cuda.device(gdense.device):
        err = fn(gdense.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                 chunks.data_ptr(), tiles_x, n_tiles, cap, exit_t,
                 int(axis), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sorted_fwd_launch failed with CUDA error {err}")
    launches += 1
    return out, chunks

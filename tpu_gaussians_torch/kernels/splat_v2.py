"""General-conic (EWA) band accumulation, forward: the CUDA kernel's
wrapper and its plain twin.

`splat_v2_fwd` launches `csrc/splat_v2_fwd.cu` (K5, the replacement of the
TPU kernel `tpu_gaussians/ops/pallas/splat.py:_fwd_kernel_v2`) for CUDA
tensors and runs `v2_fwd_plain`, the same banded range loop in torch, for
CPU tensors. It never falls back from one to the other.

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
"""

from __future__ import annotations

import ctypes

import torch

from tpu_gaussians_torch.kernels import build
from tpu_gaussians_torch.kernels.splat_sep import GD_FEAT0, GD_ROWS

TP2 = 2048      # pixels per band
FEAT_PAD = 8    # output rows
BLOCK = 128     # nb is a multiple of this (ops/splat._v2_block)

launches = 0    # kernel launches made by splat_v2_fwd


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
        x = torch.exp(dx * (gd[None, :, 2] * dx + gd[None, :, 3] * dy)
                      + (gd[None, :, 4] * dy) * dy)
        out[:, i * TP2:(i + 1) * TP2] = (
            gd[:, GD_FEAT0:GD_FEAT0 + FEAT_PAD].T @ x.T)
    return out


def _library() -> ctypes.CDLL:
    lib = build.load("splat_v2_fwd")
    fn = lib.splat_v2_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def splat_v2_fwd(lo: torch.Tensor, cnt: torch.Tensor, gdata: torch.Tensor,
                 hw_pad: int, width: int, nb: int) -> torch.Tensor:
    """K5 -> acc (8, hw_pad): the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    global launches
    _check(lo, cnt, gdata, hw_pad, width, nb)
    if gdata.device.type == "cpu":
        return v2_fwd_plain(lo, cnt, gdata, hw_pad, width, nb)
    if gdata.device.type != "cuda":
        raise ValueError(f"splat_v2_fwd runs on cuda or cpu, got "
                         f"{gdata.device}")
    if gdata.data_ptr() % 16:
        raise ValueError("gdata must be 16-byte aligned (the kernel loads "
                         "float4)")
    out = torch.empty((FEAT_PAD, hw_pad), dtype=torch.float32,
                      device=gdata.device)
    with torch.cuda.device(gdata.device):
        err = _library().splat_v2_fwd_launch(
            lo.data_ptr(), cnt.data_ptr(), gdata.data_ptr(), out.data_ptr(),
            lo.shape[0], width, nb, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"splat_v2_fwd_launch failed with CUDA error {err}")
    launches += 1
    return out

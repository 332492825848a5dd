"""Splat accumulation through the band kernels: the counterpart of
`tpu_gaussians.ops.pallas.splat.splat_accumulate`.

  acc[p, :] = sum_i op_i exp(-0.5 (a dx^2 + 2 b dx dy + c dy^2)) feats_i

The axis footprint (b == 0) factorises into Ex(x) * Ey(y), so a band of R
image rows is a sum of rank-1 products per gaussian (kernels/splat_sep.py).
Gaussians are sorted by screen y (above SORT_MM_MAX) and grouped in blocks
of nb; each band evaluates only the contiguous range of blocks whose
conservative y-extent (weight >= W_CULL) reaches it. `stage` sorts and
stages the inputs once (pad, cull mask, block ranges, packed rows);
`_SplatSep` runs K1 forward and K2 backward on them, and finishes the
gradient with an O(n) torch post-pass. The general conic (EWA) takes
2048-pixel bands (`_v2_prep`) through `_SplatV2`: K5 forward, K6 backward
(kernels/splat_v2.py) and the same kind of post-pass.

Not ported, because they exist only for the TPU's memory: the VMEM
capacity model and super-block streaming (`_sep_fits`, `_sep_pass_*`) and
the bf16x3 product split; a CUDA kernel reads gdata from device memory.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_gaussians_torch.kernels.splat_sep import (
    FEAT, GD_FEAT0, GD_ROWS, splat_sep_bwd, splat_sep_fwd)
from tpu_gaussians_torch.kernels.splat_v2 import (
    TP2, splat_v2_bwd, splat_v2_fwd)
from tpu_gaussians_torch.ops.common import SplatInputs

FEAT_PAD = 8          # feats padded to 8 columns: [r, g, b, 1, z, 0, 0, 0]
W_CULL = 1e-14        # a gaussian block skips a band only where every weight
                      # is below this: the dropped mass is under f32
                      # resolution of the sums
NB2 = 512             # largest gaussian block
SEP_ROWS_SMALL = 64   # band height R up to SEP_SMALL_MAX_N gaussians
SEP_ROWS_LARGE = 32   # and above
SEP_SMALL_MAX_N = 16_384
SORT_MM_MAX = 2048    # no y-sort at or below this many gaussians: they span
                      # at most 4 blocks, so the ranges are near full anyway


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _v2_block(n: int) -> int:
    """Gaussian block size: the multiple of 128 up to NB2 that pads n
    least (ties go to the larger block)."""
    best = NB2
    for nb in (128, 256, 384, 512):
        if _round_up(n, nb) <= _round_up(n, best):
            best = nb
    return best


def _sep_rows(n: int) -> int:
    return SEP_ROWS_SMALL if n <= SEP_SMALL_MAX_N else SEP_ROWS_LARGE


def _sep_dims(n: int, height: int, width: int) -> Tuple[int, int, int, int,
                                                        int]:
    """(nb, Wp, Hp, n_bands, R) for n gaussians on a height x width frame."""
    nb = _v2_block(n)
    rows = _sep_rows(n)
    wp = _round_up(width, 128)
    hp = _round_up(height, rows)
    return nb, wp, hp, hp // rows, rows


def _pad_inputs(px, py, ca, cb, cc, op, feats, n_pad: int):
    """Pad to n_pad gaussians: op = 0 (no weight), identity conic; feats to
    FEAT_PAD columns."""
    pad = n_pad - px.shape[0]

    def p(t, value=0.0):
        return torch.nn.functional.pad(t, (0, pad), value=value)

    feats_p = torch.nn.functional.pad(
        feats, (0, FEAT_PAD - feats.shape[1], 0, pad))
    return (p(px), p(py), p(ca, 1.0), p(cb), p(cc, 1.0), p(op), feats_p)


def _sigma_y_from_conic(a, b, c) -> torch.Tensor:
    """Effective y stddev of the conic footprint, sqrt(a / (a c - b^2))."""
    det = torch.clamp(a * c - b * b, min=1e-12)
    return torch.sqrt(torch.clamp(a, min=1e-12) / det)


def _band_block_mask(py, sigma_y, op_eff, n_bands: int, tp: int, nb: int,
                     width: int) -> torch.Tensor:
    """(n_bands, n_blocks) int32: block j is active in band i iff one of
    its gaussians' y-extent [py - r sy, py + r sy] (r from W_CULL) reaches
    the band's rows, with a one-row margin. Inputs are padded and sorted."""
    n_blocks = py.shape[0] // nb
    r = torch.sqrt(2.0 * torch.log(torch.clamp(op_eff, min=W_CULL) / W_CULL))
    dead = op_eff <= W_CULL
    inf = torch.tensor(float("inf"), dtype=py.dtype, device=py.device)
    lo = torch.where(dead, inf, py - r * sigma_y).reshape(n_blocks, nb)
    hi = torch.where(dead, -inf, py + r * sigma_y).reshape(n_blocks, nb)
    blo = lo.amin(dim=1)
    bhi = hi.amax(dim=1)
    band = torch.arange(n_bands, dtype=torch.float32, device=py.device)
    band_ylo = torch.floor(band * tp / width) - 1.0
    band_yhi = torch.ceil((band + 1.0) * tp / width) + 1.0
    active = ((blo[None, :] <= band_yhi[:, None])
              & (bhi[None, :] >= band_ylo[:, None]))
    return active.to(torch.int32)


def _block_ranges(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask (bands, blocks) -> per band (first active block, count of
    blocks through the last active one), both (n_bands,) int32."""
    any_active = mask.any(dim=1)
    first = torch.argmax(mask, dim=1)
    last = mask.shape[1] - 1 - torch.argmax(mask.flip(1), dim=1)
    zero = torch.zeros_like(first)
    lo = torch.where(any_active, first, zero).to(torch.int32)
    cnt = torch.where(any_active, last - first + 1, zero).to(torch.int32)
    return lo, cnt


def _scale_conic(ca, cb, cc):
    """Conics pre-scaled for the kernels' bare exponent a' dx^2 + c' dy^2:
    a' = -a/2, b' = -b, c' = -c/2."""
    return -0.5 * ca, -cb, -0.5 * cc


def _pack_gdata(px, py, ca, cb, cc, op, feats) -> torch.Tensor:
    """(n,) columns + feats (n, FEAT_PAD) -> row-major (n, GD_ROWS) rows
    [px, py, ca, cb, cc, op, feats * op (8), 0, 0]."""
    cols = [px, py, ca, cb, cc, op] + [feats[:, f] * op
                                       for f in range(FEAT_PAD)]
    cols += [torch.zeros_like(px)] * (GD_ROWS - len(cols))
    return torch.stack(cols, dim=1).contiguous()


def _sep_prep(px, py, ca, cb, cc, op, feats, height: int, width: int):
    """Staging shared by forward and backward: pad, cull mask, block
    ranges, packed rows -> (lo, cnt, gdata, nb, wp, hp, n_bands, rows)."""
    n = px.shape[0]
    nb, wp, hp, n_bands, rows = _sep_dims(n, height, width)
    px_p, py_p, ca_p, cb_p, cc_p, op_p, feats_p = _pad_inputs(
        px, py, ca, cb, cc, op, feats, _round_up(n, nb))
    sy_eff = _sigma_y_from_conic(ca_p, cb_p, cc_p)
    mask = _band_block_mask(py_p, sy_eff, op_p, n_bands, rows * wp, nb, wp)
    lo, cnt = _block_ranges(mask)
    sa, sb, sc = _scale_conic(ca_p, cb_p, cc_p)
    gdata = _pack_gdata(px_p, py_p, sa, sb, sc, op_p, feats_p)
    return lo, cnt, gdata, nb, wp, hp, n_bands, rows


def _v2_prep(s: SplatInputs, height: int, width: int):
    """K5's staging (splat.py:1005-1016) of s in the order given (see
    y_sorted): pad to the v2 block, cull mask over 2048-pixel bands, block
    ranges, packed rows -> (lo, cnt, gdata, nb, hw_pad). It carries no
    gradient: _SplatV2's backward builds the columns' gradients from K6's
    moments."""
    n = s.px.shape[0]
    nb = _v2_block(n)
    hw_pad = _round_up(height * width, TP2)
    with torch.no_grad():
        px_p, py_p, ca_p, cb_p, cc_p, op_p, feats_p = _pad_inputs(
            s.px, s.py, s.conic_a, s.conic_b, s.conic_c, s.op_eff, s.feats,
            _round_up(n, nb))
        sy_eff = _sigma_y_from_conic(ca_p, cb_p, cc_p)
        mask = _band_block_mask(py_p, sy_eff, op_p, hw_pad // TP2, TP2, nb,
                                width)
        lo, cnt = _block_ranges(mask)
        sa, sb, sc = _scale_conic(ca_p, cb_p, cc_p)
        gdata = _pack_gdata(px_p, py_p, sa, sb, sc, op_p, feats_p)
    return lo, cnt, gdata, nb, hw_pad


def y_sorted(s: SplatInputs) -> SplatInputs:
    """s in the order the band kernels take it: above SORT_MM_MAX, sorted by
    screen y, so that blocks are y-coherent and each band's block range is
    short. The sum does not depend on the order, and the gradient flows
    back through the gather."""
    if s.px.shape[0] > SORT_MM_MAX:
        order = torch.sort(s.py.detach(), stable=True).indices
        s = SplatInputs(*(t[order] for t in s))
    return s


def stage(s: SplatInputs, height: int, width: int):
    """The gaussians in the order the separable kernels take them, and
    their inputs for that order: (y_sorted(s), (lo, cnt, gdata, nb, wp, hp,
    n_bands, rows)). The staging itself carries no gradient: _SplatSep's
    backward builds the columns' gradients from K2's moments."""
    s = y_sorted(s)
    with torch.no_grad():
        prep = _sep_prep(s.px, s.py, s.conic_a, s.conic_b, s.conic_c,
                         s.op_eff, s.feats, height, width)
    return s, prep


class _SplatSep(torch.autograd.Function):
    """acc (H*W, 5) = sum_i w_i(p) feats_i through K1; backward through K2
    and the O(n) chain-rule post-pass (splat.py:1063-1074). conic_b is
    taken as identically zero (the axis contract), so its gradient is 0."""

    @staticmethod
    def forward(ctx, px, py, ca, cb, cc, op, feats, prep, height: int,
                width: int):
        lo, cnt, gdata, nb, wp, hp, n_bands, rows = prep
        band = splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
        ctx.save_for_backward(ca, cc, op, feats, lo, cnt, gdata)
        ctx.dims = (height, width, nb, wp, hp, n_bands, rows)
        # (n_bands, 5, R, Wp) -> (Hp, Wp, 5) -> crop to (H*W, 5)
        acc = band.permute(0, 2, 3, 1).reshape(hp, wp, FEAT)
        return acc[:height, :width].reshape(height * width, FEAT)

    @staticmethod
    def backward(ctx, g):
        ca, cc, op, feats, lo, cnt, gdata = ctx.saved_tensors
        height, width, nb, wp, hp, n_bands, rows = ctx.dims
        g8 = g.new_zeros((hp, wp, FEAT))
        g8[:height, :width] = g.reshape(height, width, FEAT)
        gband = g8.reshape(n_bands, rows, wp, FEAT).permute(
            0, 3, 1, 2).contiguous()
        out = splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
        out = out[:ca.shape[0]]   # rows [Mdx, Mdy, Mxx, 0, Myy, 0, g_featop]
        g_featop = out[:, GD_FEAT0:GD_FEAT0 + FEAT]
        return (ca * out[:, 0], cc * out[:, 1], -0.5 * out[:, 2],
                torch.zeros_like(ca), -0.5 * out[:, 4],
                (feats * g_featop).sum(dim=1), g_featop * op[:, None],
                None, None, None)


class _SplatV2(torch.autograd.Function):
    """acc (H*W, 5) = sum_i w_i(p) feats_i for any conic through K5;
    backward through K6 and the O(n) chain-rule post-pass (splat.py:
    1091-1107), with the unscaled conic and op of the unpadded inputs."""

    @staticmethod
    def forward(ctx, px, py, ca, cb, cc, op, feats, prep, height: int,
                width: int):
        lo, cnt, gdata, nb, hw_pad = prep
        acc8 = splat_v2_fwd(lo, cnt, gdata, hw_pad, width, nb)
        ctx.save_for_backward(ca, cb, cc, op, feats, lo, cnt, gdata)
        ctx.dims = (height, width, nb, hw_pad)
        return acc8[:FEAT, :height * width].T

    @staticmethod
    def backward(ctx, g):
        ca, cb, cc, op, feats, lo, cnt, gdata = ctx.saved_tensors
        height, width, nb, hw_pad = ctx.dims
        g8 = g.new_zeros((FEAT_PAD, hw_pad))
        g8[:FEAT, :height * width] = g.T
        out = splat_v2_bwd(lo, cnt, gdata, g8, hw_pad, width, nb)
        mdx, mdy, mxx, mxy, myy = out[:ca.shape[0], :5].unbind(dim=1)
        g_featop = out[:ca.shape[0], GD_FEAT0:GD_FEAT0 + FEAT]
        return (ca * mdx + cb * mdy, cb * mdx + cc * mdy, -0.5 * mxx, -mxy,
                -0.5 * myy, (feats * g_featop).sum(dim=1),
                g_featop * op[:, None], None, None, None)


def splat_accumulate(s: SplatInputs, height: int, width: int, *,
                     axis: bool) -> torch.Tensor:
    """acc (H*W, 5) of the weighted-average mode, differentiable in every
    SplatInputs field but sigma_x/y.

    axis=True is the caller's promise that conic_b == 0: the separable
    band kernels K1/K2. axis=False takes any conic through the
    general-conic band kernels K5/K6."""
    if not axis:
        s = y_sorted(s)
        prep = _v2_prep(s, height, width)
        return _SplatV2.apply(s.px, s.py, s.conic_a, s.conic_b, s.conic_c,
                              s.op_eff, s.feats, prep, height, width)
    s, prep = stage(s, height, width)
    return _SplatSep.apply(s.px, s.py, s.conic_a, s.conic_b, s.conic_c,
                           s.op_eff, s.feats, prep, height, width)

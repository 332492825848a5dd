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
gradient with an O(n) torch post-pass. The general conic (EWA) goes
through `_SplatGeneral`: up to JAX's v2 sizes (`_choose_v2`) 2048-pixel
bands (`_v2_prep`) through K5 forward and K6 backward (kernels/splat_v2.py)
with the same kind of post-pass, above them a (pixel tile x gaussian
block) grid under a cull mask (`_v1_prep`) through K9a forward and K9b
backward (kernels/splat_v1.py), whose output is the gradient itself.
Forward and backward choose their route each for itself, as in JAX.

Not ported, because they exist only for the TPU's memory: the VMEM
capacity model and super-block streaming (`_sep_fits`, `_sep_pass_*`) and
the bf16x3 product split; a CUDA kernel reads gdata from device memory.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpu_gaussians_torch.kernels.splat_sep import (
    FEAT, GD_FEAT0, GD_ROWS, splat_sep_bwd, splat_sep_fwd)
from tpu_gaussians_torch.kernels.splat_v1 import splat_v1_bwd, splat_v1_fwd
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
# The largest round_up(n, NB2) whose EWA forward (backward) takes the band
# kernels K5 (K6); above it the tile-grid kernels K9a (K9b). These are
# JAX's `_choose_v2` / `_v2_fits` (splat.py:320-323, 416-423), where v2
# keeps its packed gaussian data resident in the TPU's VMEM: (80 MiB -
# 8*512*2048*4 B of temporaries) / (64 B per gaussian forward, 128 B
# backward). They are kept so that the port takes the reference's kernel
# at the same n, not because the card's memory needs them.
V2_MAX_N_PAD_FWD = 786_432
V2_MAX_N_PAD_BWD = 393_216
V1_NB = 512           # largest gaussian block of the tile grid
V1_TP = 2048          # largest pixel tile of the tile grid


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


def _tile_sizes(n: int, hw: int) -> Tuple[int, int]:
    """(nb gaussians per block, tp pixels per tile) of the tile grid
    (splat.py:183-187)."""
    return (min(V1_NB, _round_up(max(n, 1), 128)),
            min(V1_TP, _round_up(max(hw, 1), 128)))


def _choose_v2(n: int, backward: bool) -> bool:
    """Whether the EWA accumulation of n gaussians takes the band kernels
    (K5 forward, K6 backward) rather than the tile grid (K9a, K9b): JAX's
    `_choose_v2`, each direction with its own threshold."""
    return _round_up(n, NB2) <= (V2_MAX_N_PAD_BWD if backward
                                 else V2_MAX_N_PAD_FWD)


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
    [px, py, ca, cb, cc, op, feats (8), 0, 0]. The band kernels take
    feats * op (featsop) there, the tile grid feats."""
    cols = [px, py, ca, cb, cc, op] + list(feats.unbind(dim=1))
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
    gdata = _pack_gdata(px_p, py_p, sa, sb, sc, op_p,
                        feats_p * op_p[:, None])
    return lo, cnt, gdata, nb, wp, hp, n_bands, rows


class V2Staging(NamedTuple):
    """K5/K6's inputs: per 2048-pixel band the first active block and the
    count of blocks through the last active one, the packed rows (conic
    pre-scaled, feats * op), the block size and the padded pixel count."""
    lo: torch.Tensor
    cnt: torch.Tensor
    gdata: torch.Tensor
    nb: int
    hw_pad: int


class V1Staging(NamedTuple):
    """K9a/K9b's inputs: the (tile, block) cull mask (uint8), the packed
    rows (conic unscaled, feats as given), the block size, the tile's pixel
    count and the padded pixel count."""
    mask: torch.Tensor
    gdata: torch.Tensor
    nb: int
    tp: int
    hw_pad: int


def _v2_prep(s: SplatInputs, height: int, width: int) -> V2Staging:
    """K5's staging (splat.py:1005-1016) of s in the order given (see
    y_sorted): pad to the v2 block, cull mask over 2048-pixel bands, block
    ranges, packed rows. It carries no gradient: _SplatGeneral's backward
    builds the columns' gradients from K6's moments."""
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
        gdata = _pack_gdata(px_p, py_p, sa, sb, sc, op_p,
                            feats_p * op_p[:, None])
    return V2Staging(lo, cnt, gdata, nb, hw_pad)


def _v1_prep(s: SplatInputs, height: int, width: int) -> V1Staging:
    """K9's staging (splat.py:1019-1030, 1108-1119) of s in the order given
    (see y_sorted): pad to the block nb, cull mask over tp-pixel tiles (one
    byte per (tile, block): the TPU's bit packing is for its scalar
    memory), rows unscaled. It carries no gradient: K9b returns the
    columns' gradients."""
    n = s.px.shape[0]
    nb, tp = _tile_sizes(n, height * width)
    hw_pad = _round_up(height * width, tp)
    with torch.no_grad():
        px_p, py_p, ca_p, cb_p, cc_p, op_p, feats_p = _pad_inputs(
            s.px, s.py, s.conic_a, s.conic_b, s.conic_c, s.op_eff, s.feats,
            _round_up(n, nb))
        sy_eff = _sigma_y_from_conic(ca_p, cb_p, cc_p)
        mask = _band_block_mask(py_p, sy_eff, op_p, hw_pad // tp, tp, nb,
                                width).to(torch.uint8)
        gdata = _pack_gdata(px_p, py_p, ca_p, cb_p, cc_p, op_p, feats_p)
    return V1Staging(mask, gdata, nb, tp, hw_pad)


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


class _SplatGeneral(torch.autograd.Function):
    """acc (H*W, 5) = sum_i w_i(p) feats_i for any conic. Forward: K5 on
    the band staging, or K9a on the tile grid's, by _choose_v2; backward
    chosen anew as in JAX (`_splat_fwd` / `_splat_bwd`, splat.py:1001-1130):
    K6 and the O(n) chain-rule post-pass, or K9b, whose rows are the
    gradients. A backward on the forward's route reuses its staging (kept
    on ctx: it is neither an input nor an output); one on the other route
    (393,217 to 786,432 gaussians: K5 forward, K9b backward) restages from
    the saved columns."""

    @staticmethod
    def forward(ctx, px, py, ca, cb, cc, op, feats, height: int,
                width: int):
        s = _columns(px, py, ca, cb, cc, op, feats)
        ctx.v2 = _choose_v2(px.shape[0], backward=False)
        if ctx.v2:
            st = _v2_prep(s, height, width)
            acc8 = splat_v2_fwd(st.lo, st.cnt, st.gdata, st.hw_pad, width,
                                st.nb)
        else:
            st = _v1_prep(s, height, width)
            acc8 = splat_v1_fwd(st.mask, st.gdata, st.hw_pad, width, st.nb,
                                st.tp)
        ctx.save_for_backward(px, py, ca, cb, cc, op, feats)
        ctx.staging = st
        ctx.frame = (height, width)
        return acc8[:FEAT, :height * width].T

    @staticmethod
    def backward(ctx, g):
        px, py, ca, cb, cc, op, feats = ctx.saved_tensors
        height, width = ctx.frame
        n = ca.shape[0]
        v2 = _choose_v2(n, backward=True)
        st = ctx.staging
        if v2 != ctx.v2:
            s = _columns(px, py, ca, cb, cc, op, feats)
            st = (_v2_prep if v2 else _v1_prep)(s, height, width)
        g8 = g.new_zeros((FEAT_PAD, st.hw_pad))
        g8[:FEAT, :height * width] = g.T
        nulls = (None, None)
        if not v2:
            out = splat_v1_bwd(st.mask, st.gdata, g8, st.hw_pad, width,
                               st.nb, st.tp)[:n]
            return (*out[:, :6].unbind(dim=1),
                    out[:, GD_FEAT0:GD_FEAT0 + FEAT], *nulls)
        out = splat_v2_bwd(st.lo, st.cnt, st.gdata, g8, st.hw_pad, width,
                           st.nb)
        mdx, mdy, mxx, mxy, myy = out[:n, :5].unbind(dim=1)
        g_featop = out[:n, GD_FEAT0:GD_FEAT0 + FEAT]
        return (ca * mdx + cb * mdy, cb * mdx + cc * mdy, -0.5 * mxx, -mxy,
                -0.5 * myy, (feats * g_featop).sum(dim=1),
                g_featop * op[:, None], *nulls)


def _columns(px, py, ca, cb, cc, op, feats) -> SplatInputs:
    """SplatInputs of the columns the staging reads (sigma_x/y are not)."""
    zero = torch.zeros_like(px)
    return SplatInputs(px, py, ca, cb, cc, zero, zero, op, feats)


def splat_accumulate(s: SplatInputs, height: int, width: int, *,
                     axis: bool) -> torch.Tensor:
    """acc (H*W, 5) of the weighted-average mode, differentiable in every
    SplatInputs field but sigma_x/y.

    axis=True is the caller's promise that conic_b == 0: the separable
    band kernels K1/K2. axis=False takes any conic through the
    general-conic band kernels K5/K6, or above JAX's v2 sizes the tile
    grid's K9a/K9b (_choose_v2, per direction)."""
    if not axis:
        s = y_sorted(s)
        return _SplatGeneral.apply(s.px, s.py, s.conic_a, s.conic_b,
                                   s.conic_c, s.op_eff, s.feats, height,
                                   width)
    s, prep = stage(s, height, width)
    return _SplatSep.apply(s.px, s.py, s.conic_a, s.conic_b, s.conic_c,
                           s.op_eff, s.feats, prep, height, width)

"""K7b's tensor-core arithmetic (csrc/binned_sep_bwd.cu), emulated without
a card, against its plain twin `kernels.binned.binned_sep_bwd_plain`,
which the port's parity tests hold to the TPU kernel.

The emulation does what the kernel does, per tile, for every slot of the
processed 512-slot chunks (those past cnt are the dead row, computed like
any other), per column slice of the kernel's rule (1 or 2 halves of the
tile's 128 columns):
- log2(e) folded into the conic: Ex = 2^(-a/2 log2(e) tx^2), Ey likewise,
  G2 = featsop_f x Ey, all in f32;
- each operand of a product split as x = big + small (big = x with its 13
  low mantissa bits cleared, small read by the tensor core to TF32); the
  three products big.big' + big.small' + small.big' exact (f64) and
  rounded to f32 once, at the end of the accumulator's one run:
  P2  gEx = G2 . gband over all 128 rows (f, r);
  P1  gG2 = Ex . gband^T over the slice's columns;
- Mdx, Mxx per lane t: t1 = (gEx Ex) tx added over the lane's columns 8i +
  2t + e of the slice in (i, e) order, Mxx by fma;
- per lane t and its rows 2t, 2t + 1, 8 + 2t, 9 + 2t in that order:
  g_featop = sum_r gG2 Ey (the first a product, then fma), gEy = sum_f gG2
  featsop (over the features in order), then Mdy += (gEy Ey) ty and Myy by
  fma;
- the 4 lanes of a slot by the kernel's butterfly ((t0 + t1) + (t2 +
  t3)), then the slices in order.

Tolerance: K7b's against its twin on the card (chip_smoke.py,
tests/test_torch_port_cuda.py): rtol 2e-4, and atol 2e-5 times the
largest magnitude of the output column (at least 1), on an N(0, 1)
cotangent: on the axis binned parity lists of
tests/test_torch_port_axis_binned.py (2 column slices by the kernel's
rule, and 1), and on one heavy axis tile
(tests/test_torch_port_binned_sep_tc.heavy_axis_tile: sigmas 2-5 pixels)
of 8,192 and of 7,000 slots with 1 column slice (the 100k 512x512 axis
scene's 128 tiles at cap 8192) and 2 (the flagship's 8 tiles at cap 3072).
The same check fails with the small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import binned
from tpu_gaussians_torch.kernels.splat_v2 import EXP_FLOOR
from tpu_gaussians_torch.ops.binning import TH, TPS, TWC

from .test_torch_port_binned_bwd_tc import cotangent, fma, product
from .test_torch_port_binned_sep_tc import heavy_axis_tile
from .test_torch_port_cuda import (TILES_X, assert_moments_close,
                                   synthetic_lists)

NBS = 512                 # slots per chunk
MT, WARPS = 16, 8         # slots per warp and group, warps per block
TARGET_BLOCKS = 2048      # csrc/binned_sep_bwd.cu's
LOG2E = np.float32(1.4426950408889634)


def slicing(n_tiles, cap):
    """(column slices, slots per block): the kernel's rule
    (csrc/binned_sep_bwd.cu:slicing) from host shapes: the most groups of
    128 slots a block walks (4, 2, 1), then the fewest column slices (1,
    2), that give about TARGET_BLOCKS blocks."""
    groups, slices = 4, 1

    def block_slots():
        return MT * (WARPS // slices) * groups

    while groups > 1 and n_tiles * (cap // block_slots()) < TARGET_BLOCKS:
        groups //= 2
    while slices < 2 and n_tiles * (cap // block_slots()) < TARGET_BLOCKS:
        slices *= 2
    return slices, block_slots()


def exp_folded(coef, d):
    """exp(-coef/2 d^2) as K7b forms it: 2^((-0.5 log2(e) coef) d^2), the
    exponent floored at EXP_FLOOR for the CPU's exp2."""
    return torch.exp2(torch.clamp(((np.float32(-0.5) * LOG2E) * coef)
                                  * (d * d), min=EXP_FLOOR * float(LOG2E)))


def quad(v):
    """The sum over the 4 lanes t of a slot (dim 1 of v), as the kernel's
    two xor shuffles form it."""
    return (v[:, 0] + v[:, 1]) + (v[:, 2] + v[:, 3])


def k7b_emulated(gdense, cnt, g8, tiles_x, slices, small=True):
    """K7b's rows as the kernel forms them, with `slices` column slices;
    small=False keeps only the big.big' products."""
    n_tiles = cnt.shape[0]
    cap = gdense.shape[0] // n_tiles
    g = gdense.reshape(n_tiles, cap, 16)
    xc, yr = binned._tile_axes(n_tiles, tiles_x, "cpu")
    gband = g8.reshape(8, n_tiles, TPS).permute(1, 0, 2).reshape(
        n_tiles, 8 * TH, TWC)                     # rows (f, r)
    out = torch.zeros((n_tiles, cap, 16))
    width = TWC // slices
    for tile in range(n_tiles):
        live = min(max(int(cnt[tile]), 0), cap)
        end = min(-(-live // NBS) * NBS, cap)     # the processed chunks
        if end == 0:
            continue
        rows = g[tile, :end]
        tx = xc[tile][None, :] - rows[:, 0:1]    # (m, 128)
        ty = yr[tile][None, :] - rows[:, 1:2]    # (m, 16)
        ex = exp_folded(rows[:, 2:3], tx)
        ey = exp_folded(rows[:, 4:5], ty)
        fo = rows[:, 6:14] * rows[:, 5:6]
        g2 = (fo[:, :, None] * ey[:, None, :]).reshape(end, 8 * TH)
        # The lane's rows r = 8 rh + 2t + e as (slot, t, q = 2 rh + e).
        eyl = ey.reshape(end, 2, 4, 2).permute(0, 2, 1, 3).reshape(end, 4, 4)
        tyl = ty.reshape(end, 2, 4, 2).permute(0, 2, 1, 3).reshape(end, 4, 4)
        total = None
        for s in range(slices):
            cols = slice(s * width, (s + 1) * width)
            gb = gband[tile][:, cols].contiguous()
            gex = product(g2, gb, small)                          # P2
            gg2 = product(ex[:, cols].contiguous(), gb.T.contiguous(),
                          small)                                  # P1
            # Mdx, Mxx per lane t over its columns 8i + 2t + e.
            t1 = ((gex * ex[:, cols]) * tx[:, cols]).reshape(end, -1, 4, 2)
            txv = tx[:, cols].reshape(end, -1, 4, 2)
            mdx = torch.zeros((end, 4))
            mxx = torch.zeros((end, 4))
            for i in range(width // 8):
                for e in range(2):
                    mdx = mdx + t1[:, i, :, e]
                    mxx = fma(t1[:, i, :, e], txv[:, i, :, e], mxx)
            # g_featop and gEy per lane over its rows q, then Mdy, Myy.
            v = gg2.reshape(end, 8, 2, 4, 2).permute(0, 1, 3, 2, 4).reshape(
                end, 8, 4, 4)                     # (slot, f, t, q)
            gfo = v[:, :, :, 0] * eyl[:, None, :, 0]
            for q in range(1, 4):
                gfo = fma(v[:, :, :, q], eyl[:, None, :, q], gfo)
            gey = v[:, 0] * fo[:, 0, None, None]
            for f in range(1, 8):
                gey = fma(v[:, f], fo[:, f, None, None], gey)
            t2 = (gey * eyl) * tyl                # (slot, t, q)
            mdy, myy = t2[..., 0], t2[..., 0] * tyl[..., 0]
            for q in range(1, 4):
                mdy = mdy + t2[..., q]
                myy = fma(t2[..., q], tyl[..., q], myy)
            sums = torch.cat([torch.stack([quad(mdx), quad(mdy), quad(mxx),
                                           quad(myy)], dim=1),
                              quad(gfo.permute(0, 2, 1))], dim=1)
            total = sums if total is None else total + sums
        zero = torch.zeros((end, 1))
        out[tile, :end, :14] = torch.cat(
            [total[:, 0:3], zero, total[:, 3:4], zero, total[:, 4:]], dim=1)
    return out.reshape(n_tiles * cap, 16)


CASES = {
    "axis_lists_rule": ((1024, 600, 0, 300), None),
    "axis_lists_one_slice": ((1024, 600, 0, 300), 1),
    "chunk_edges_rule": ((1, 512, 513, 1024), None),
    "chunk_edges_one_slice": ((1, 512, 513, 1024), 1),
    "heavy_8192_slices1": (8192, 1),
    "heavy_8192_slices2": (8192, 2),
    "heavy_7000_slices1": (7000, 1),
    "heavy_7000_slices2": (7000, 2),
}


def case_inputs(case):
    cnt, slices = CASES[case]
    if case.startswith("heavy"):
        gdense, cnt_t = heavy_axis_tile(cnt)
        return gdense, cnt_t, cotangent(1), 1, slices
    gdense, cnt_t = synthetic_lists(True, cnt=cnt)
    n_tiles = cnt_t.shape[0]
    rule, _ = slicing(n_tiles, gdense.shape[0] // n_tiles)
    assert rule == 2
    return gdense, cnt_t, cotangent(n_tiles), TILES_X, slices or rule


@pytest.mark.parametrize("case", sorted(CASES))
def test_k7b_tf32_split_arithmetic_matches_twin(case):
    """K7b's arithmetic against the twin at K7b's tolerance: on the axis
    binned parity lists (a full tile, a partial second chunk, an empty
    tile, counts on either side of a 512-slot chunk edge, the dead slots
    of tile 0's processed chunk, whose g_featop is not 0) with the rule's
    2 column slices and with 1, and on the heavy axis tile of 8,192 and
    7,000 slots (its last chunk partly dead) with 1 column slice (the 100k
    scene's) and 2 (the flagship's)."""
    gdense, cnt, g8, tiles_x, slices = case_inputs(case)
    got = k7b_emulated(gdense, cnt, g8, tiles_x, slices)
    ref = binned.binned_sep_bwd_plain(gdense, cnt, g8, tiles_x)
    n_tiles = cnt.shape[0]
    rows = got.reshape(n_tiles, -1, 16)
    for t, c in enumerate(cnt.tolist()):     # chunks at or past cnt: zero
        assert not rows[t, -(-c // NBS) * NBS:].any()
    c0 = int(cnt[0])
    if c0 % NBS:                             # tile 0 at the origin
        dead = ref.reshape(n_tiles, -1, 16)[0, c0:-(-c0 // NBS) * NBS]
        assert dead[:, 6:14].any() and not dead[:, :6].any()
    if case.startswith("heavy"):
        assert float(ref[:, 2].abs().max()) > 100    # Mxx's sums cancel
    assert_moments_close(got.numpy(), ref.numpy())


def test_k7b_without_small_products_fails_the_check():
    """The same check on the heavy tile fails with one TF32 product: the
    split's small terms are what keep K7b within its tolerance."""
    gdense, cnt, g8, tiles_x, slices = case_inputs("heavy_8192_slices1")
    got = k7b_emulated(gdense, cnt, g8, tiles_x, slices, small=False)
    ref = binned.binned_sep_bwd_plain(gdense, cnt, g8, tiles_x)
    scale = torch.clamp(ref.abs().amax(dim=0), min=1.0)
    err = ((got - ref).abs() / (2e-4 * ref.abs() + 2e-5 * scale)).max()
    assert float(err) > 10


@pytest.mark.parametrize("shape,rule", [
    ((128, 8192), (1, 512)),   # the 100k 512x512 axis scene
    ((8, 3072), (2, 64)),      # the flagship axis binned fit
    ((4, 1024), (2, 64)),      # the 2x2 parity and card lists
    ((32, 8192), (1, 128)),    # a 32-tile grid at cap 8192
], ids=["100k_scene", "flagship", "lists_2x2", "grid_32_tiles"])
def test_slicing_rule_at_the_cells_shapes(shape, rule):
    """The rule's (column slices, slots per block) at the shapes the kernel
    meets: the 100k scene's 128 tiles walk 4 groups of 128 slots a block
    in one slice; the flagship's 8 tiles and the 2x2 lists split each
    block's columns in 2 (64 slots a block); a 32-tile grid at cap 8192
    takes 128 slots a block in one slice (the card tests' block edges)."""
    assert slicing(*shape) == rule

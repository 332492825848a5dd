"""K7a's tensor-core arithmetic (csrc/binned_sep_fwd.cu), emulated without
a card, against its plain twin `kernels.binned.binned_sep_fwd_plain`,
which the port's parity tests hold to the TPU kernel.

The emulation does what the kernel does: per tile, log2(e) folded into
the conic and Ex = 2^(-a/2 log2(e) tx^2), Ey likewise, G2 = featsop_f x Ey,
all in f32; each operand split as x = big + small (big = x with its 13
low mantissa bits cleared, small read by the tensor core to TF32); the
three products big.big' + big.small' + small.big' exact (f64) and summed
over a 64-slot chunk, rounded to f32 once a chunk; the chunk partials
added into an f32 total in chunk order within a slice of the tile's list
(the slice stops at cnt rounded up to 64 slots), and the slice totals
added in slice order.

Tolerance: rtol 1e-5 / atol 1e-5, K7a's against its twin on the card
(chip_smoke.py, tests/test_torch_port_cuda.py): on the lists of
tests/test_torch_port_axis_binned.py, and on one heavy axis tile of 8,192
slots whose sums (up to 44 in the row of ones and 116 in z) reach those of
the 100k-gaussian 512x512 axis scene (36 and 93 at its initial
parameters, view 0, by the twin on tools/ab_k7a.py's lists). The same
check fails with the small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import binned
from tpu_gaussians_torch.kernels.splat_v2 import EXP_FLOOR
from tpu_gaussians_torch.ops.binning import TH, TPS, TWC

from .test_torch_port_binned_tc import heavy_tile, tf32
from .test_torch_port_cuda import TILES_X, synthetic_lists

KC = 64            # slots per chunk (the mma accumulator's restart)
LOG2E = 1.4426950408889634
# K7a's slice lengths (csrc/binned_sep_fwd.cu:slice_len): its least, 128,
# on the 2x2-tile lists at cap 1024 and on the flagship's 8 tiles at cap
# 3072; 1024 on the 100k scene's 128 tiles at cap 8192.
LISTS_SLICE, FLAGSHIP_SLICE, SCENE_SLICE = 128, 128, 1024


def exp_folded(coef, d):
    """exp(coef d^2) as K7a forms it: 2^((coef log2 e) d^2), the exponent
    floored at EXP_FLOOR for the CPU's exp2."""
    return torch.exp2(torch.clamp((LOG2E * -0.5 * coef) * (d * d),
                                  min=EXP_FLOOR * LOG2E))


def k7a_emulated(gdense, cnt, tiles_x, length, small=True):
    """K7a's sums as the kernel forms them, with slices of `length` slots;
    small=False keeps only the big.big' product."""
    n_tiles = cnt.shape[0]
    cap = gdense.shape[0] // n_tiles
    g = gdense.reshape(n_tiles, cap, 16)
    xc, yr = binned._tile_axes(n_tiles, tiles_x, "cpu")
    out = torch.zeros((n_tiles, 8 * TH, TWC))
    for t in range(n_tiles):
        end = -(-min(max(int(cnt[t]), 0), cap) // KC) * KC
        parts = []
        for s in range(0, max(end, 1), length):      # slice 0 at least
            total = torch.zeros((8 * TH, TWC))
            for c in range(s, min(s + length, end), KC):
                rows = g[t, c:c + KC]
                eb = exp_folded(rows[:, 2:3], xc[t][None, :] - rows[:, 0:1])
                ey = exp_folded(rows[:, 4:5], yr[t][None, :] - rows[:, 1:2])
                fo = rows[:, 6:14] * rows[:, 5:6]
                g2 = (fo[:, :, None] * ey[:, None, :]).flatten(1).T
                gb, xb = tf32(g2), tf32(eb)
                prod = gb.double() @ xb.double()
                if small:
                    prod += (tf32(g2 - gb).double() @ xb.double()
                             + gb.double() @ tf32(eb - xb).double())
                total += prod.float()
            parts.append(total)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[t] = acc
    return out.reshape(n_tiles, 8, TPS).permute(1, 0, 2).reshape(
        8, n_tiles * TPS)


def heavy_axis_tile(count=8192, cap=8192):
    """tests/test_torch_port_binned_tc.heavy_tile with conic b = 0: one
    tile of `count` axis-aligned slots (sigmas 2-5 pixels) at capacity
    `cap`."""
    gdense, cnt = heavy_tile(count, cap)
    gdense[:, 3] = 0.0
    return gdense, cnt


CASES = {
    "full_partial_empty_short": ((1024, 600, 0, 300), LISTS_SLICE),
    "chunk_edges": ((1, 512, 513, 1024), LISTS_SLICE),
    "heavy_8192_len128": (8192, FLAGSHIP_SLICE),
    "heavy_8192_len1024": (8192, SCENE_SLICE),
    "heavy_7000_len1024": (7000, SCENE_SLICE),
    "heavy_1000_len128": (1000, FLAGSHIP_SLICE),
}


def case_inputs(case):
    cnt, length = CASES[case]
    if case.startswith("heavy"):
        return (*heavy_axis_tile(cnt), 1), length
    return (*synthetic_lists(True, cnt=cnt), TILES_X), length


@pytest.mark.parametrize("case", sorted(CASES))
def test_k7a_tf32_split_arithmetic_matches_twin(case):
    """K7a's arithmetic against the twin at K7a's tolerance, rtol 1e-5 /
    atol 1e-5: on the axis binned parity lists (a full tile, a partial
    second chunk, an empty tile, counts on either side of a 512-slot chunk
    edge) and on the heavy axis tile with the flagship's slice length
    (128: 64 slices, and 8 with a list of 1,000, longer than the
    flagship's longest) and the 100k scene's (1024: 8 slices, and 7 with the last
    one partial and its last chunk ending past cnt)."""
    (gdense, cnt, tiles_x), length = case_inputs(case)
    assert not gdense[:, 3].any()
    got = k7a_emulated(gdense, cnt, tiles_x, length)
    ref = binned.binned_sep_fwd_plain(gdense, cnt, tiles_x)
    if case.startswith("heavy_8192"):
        assert 30 < float(ref[3].max()) < 60
        assert 70 < float(ref[4].max()) < 150
    if case == "full_partial_empty_short":
        assert not got.reshape(8, 4, TPS)[:, 2].any()   # the empty tile
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_k7a_without_small_products_fails_the_check():
    """The same check on the heavy axis tile fails with one TF32 product:
    the split's small terms are what keeps K7a within 1e-5."""
    gdense, cnt = heavy_axis_tile()
    got = k7a_emulated(gdense, cnt, 1, SCENE_SLICE, small=False)
    ref = binned.binned_sep_fwd_plain(gdense, cnt, 1)
    assert not torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
    err = ((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max()
    assert float(err) > 10

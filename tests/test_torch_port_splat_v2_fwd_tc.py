"""K5's tensor-core arithmetic (csrc/splat_v2_fwd.cu), emulated without a
card, against its plain twin `kernels.splat_v2.v2_fwd_plain`, which the
port's parity tests hold to the TPU kernel
(tests/test_torch_port_sorted_fit.py).

The emulation does what the kernel does, for each band and each of the
kernel's slices of the band's gaussian range (dealt chunk by chunk: slice
s takes the 128-row chunks s, s + slices, ... of the range; a band's live
slices are those that hold a chunk, and at least slice 0):
- log2(e) folded into the pre-scaled conic (a', b', c' of the staging), e =
  fma(dx, fma(a', dx, b' dy), c' dy^2) with b' dy and (c' dy) dy rounded
  as the kernel rounds them, and x = 2^e;
- each operand of the product split as x = big + small (big = x with its
  13 low mantissa bits cleared, small read by the tensor core to TF32), the
  three products big.big' + big.small' + small.big' exact (f64) and
  rounded to f32 once a chunk, as the mma accumulator restarts every chunk;
- the chunk partials added into the slice's f32 total in chunk order, then
  the live slices' totals in slice order.
The kernel skips a chunk whose 128 rows all have featsop 0; its terms are
exactly 0, so the emulation, which evaluates it, gives the same sums.
Exponents are floored at the twin's EXP_FLOOR: the kernel's exp flushes
results below 2^-126 to 0, which moves a sum by less than 1e-37 a term.

Tolerance: K5's against its twin on the card (chip_smoke.py,
tests/test_torch_port_cuda.py), rtol/atol 1e-5. The same check fails with
the small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import splat_v2
from tpu_gaussians_torch.ops import splat as tsplat

from .test_torch_port_binned_bwd_tc import fma, product
from .test_torch_port_cuda import (splat_inputs, synthetic_splats,
                                   v2_bwd_edge_inputs)
from .test_torch_port_splat_v1 import heavy_inputs

TP2 = 2048            # pixels per band
CHUNK = 128           # gaussian rows staged at a time
LOG2E = np.float32(1.4426950408889634)
# csrc/splat_v2_fwd.cu's slice rule: up to MAX_SLICES, BLOCKS_PER_BAND
# blocks a band and slice, TARGET_PER_SM blocks per SM.
BLOCKS_PER_BAND, MAX_SLICES, TARGET_PER_SM = 4, 16, 6
H100_SMS = 132


def band_slices(n_bands, n_pad, sms=H100_SMS):
    """The kernel's rule (csrc/splat_v2_fwd.cu:band_slices), from host
    shapes: the fewest slices (1, 2, 4, 8, 16, and at most n_pad / 128)
    that give the grid of n_bands x 4 blocks a slice TARGET_PER_SM blocks
    per SM, trimmed to those that a range of n_pad rows fills."""
    blocks, chunks, slices = n_bands * BLOCKS_PER_BAND, n_pad // CHUNK, 1
    while (slices < MAX_SLICES and 2 * slices <= chunks
           and blocks * slices < TARGET_PER_SM * sms):
        slices *= 2
    per = -(-chunks // slices)
    return -(-chunks // per)


def live_slices(cnt_blocks, nb, slices):
    """The slices of a band's range that hold a chunk, at least 1."""
    return max(1, min(slices, cnt_blocks * (nb // CHUNK)))


def chunk_partial(rows, gx, gy, small):
    """One 128-row chunk's sums (8, pixels) as the restarted mma
    accumulator gives them."""
    px, py = rows[:, 0:1], rows[:, 1:2]
    ah, bh, ch = (LOG2E * rows[:, c:c + 1] for c in (2, 3, 4))
    dx = gx[None, :] - px                                  # (128, pixels)
    dy = gy[None, :] - py
    e = fma(dx, fma(ah, dx, bh * dy), (ch * dy) * dy)
    x = torch.exp2(torch.clamp(e, min=splat_v2.EXP_FLOOR * LOG2E))
    return product(rows[:, 6:14].T, x, small)


def k5_emulated(lo, cnt, gdata, hw_pad, width, nb, slices, small=True):
    """K5's acc (8, hw_pad) as the kernel forms it, with `slices` slices of
    each band's range."""
    out = torch.empty((8, hw_pad))
    for band, (l, c) in enumerate(zip(lo.tolist(), cnt.tolist())):
        idx = band * TP2 + torch.arange(TP2)
        gx = (idx % width).float() + np.float32(0.5)
        gy = (idx // width).float() + np.float32(0.5)
        c0, c1 = l * (nb // CHUNK), (l + c) * (nb // CHUNK)
        total = None
        for s in range(live_slices(c, nb, slices)):
            acc = torch.zeros((8, TP2))
            for k in range(c0 + s, c1, slices):
                acc = acc + chunk_partial(gdata[k * CHUNK:(k + 1) * CHUNK],
                                          gx, gy, small)
            total = acc if total is None else total + acc
        out[:, band * TP2:(band + 1) * TP2] = total
    return out


def staged_case(n, height, width, seed=4):
    """(lo, cnt, gdata, hw_pad, width, nb) of seeded general conics staged
    by ops/splat._v2_prep (y-sorted above SORT_MM_MAX)."""
    cols = list(synthetic_splats(n, height, width, seed=seed))
    rng = np.random.default_rng(seed + 1)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    st = tsplat._v2_prep(tsplat.y_sorted(splat_inputs(cols)), height, width)
    return st.lo, st.cnt, st.gdata, st.hw_pad, width, st.nb


def edge_case():
    """Width 200 (warps straddle rows, bands end mid-row, the last band
    partly past the frame), nb = 256: band 0's range ends in the nb-block
    that holds the padding rows, band 2's is empty, band 4's runs to the
    last block; ranges of 0 to 8 chunks of 128 rows."""
    lo, cnt, gdata, _, hw_pad = v2_bwd_edge_inputs(
        200, 41, 256, 7, [(4, 3), (1, 3), (0, 0), (0, 1), (3, 4)],
        7 * 256 - 100, seed=3)
    return lo, cnt, gdata, hw_pad, 200, 256


def heavy_case():
    """K9a's heavy tile in K5's staging: one band under 2048 wide gaussians
    (sigmas 20-40 pixels) in 4 blocks of 512, each pixel summing every one;
    the sums of the feature row of ones reach the 1M-gaussian scene's
    (about 900)."""
    _, gd, nb, _, hw_pad = heavy_inputs()
    st = gd.clone()
    st[:, 2], st[:, 3] = -0.5 * gd[:, 2], -gd[:, 3]
    st[:, 4] = -0.5 * gd[:, 4]
    st[:, 6:14] = gd[:, 6:14] * gd[:, 5:6]
    lo, cnt = (torch.tensor([v], dtype=torch.int32) for v in (0, 4))
    return lo, cnt, st, hw_pad, 64, nb


# (inputs, slices): the flagship EWA accum fit's shape (3,000 gaussians at
# 128x128: n_pad 3072, 8 bands, the rule's 12 slices), the edge case in
# one and in several slices (more slices than some ranges have chunks),
# and the heavy band in the rule's 16 slices and in one.
CASES = {
    "flagship_shape": (lambda: staged_case(3000, 128, 128), 12),
    "ragged_width_slices1": (edge_case, 1),
    "ragged_width_slices4": (edge_case, 4),
    "ragged_width_slices16": (edge_case, 16),
    "heavy_slices1": (heavy_case, 1),
    "heavy_slices16": (heavy_case, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k5_tf32_split_arithmetic_matches_twin(case):
    """K5's arithmetic against the twin at K5's tolerance, rtol/atol 1e-5,
    on each case with the slice count it names; an empty band's columns
    are exactly zero."""
    make, slices = CASES[case]
    lo, cnt, gdata, hw_pad, width, nb = make()
    got = k5_emulated(lo, cnt, gdata, hw_pad, width, nb, slices)
    ref = splat_v2.v2_fwd_plain(lo, cnt, gdata, hw_pad, width, nb)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    for band in torch.nonzero(cnt == 0).flatten().tolist():
        assert not got[:, band * TP2:(band + 1) * TP2].any()
    if case.startswith("heavy"):
        assert 800 < float(ref[3].max()) < 1000
    if case.startswith("ragged"):
        assert (cnt == 0).any() and hw_pad > 200 * 41
        assert live_slices(1, nb, slices) == min(slices, 2)


def test_k5_without_small_products_fails_the_check():
    """The same check fails with one TF32 product (on the heavy band in
    the rule's 16 slices): the split's small terms are what keeps K5
    within its tolerance."""
    lo, cnt, gdata, hw_pad, width, nb = heavy_case()
    got = k5_emulated(lo, cnt, gdata, hw_pad, width, nb, 16, small=False)
    ref = splat_v2.v2_fwd_plain(lo, cnt, gdata, hw_pad, width, nb)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_band_slices_rule_at_the_cells_shapes():
    """The rule's slices on an H100 (132 SMs) at the shapes K5 meets: the
    flagship EWA accum fit (8 bands, n_pad 3072: 24 chunks) takes 12, the
    16 that its grid asks for trimmed to those a full range fills; the
    512x512 frames (128 bands: the 8,192-gaussian kernel case, the 100k
    dense scene, the 500k mixed cell and the route's largest n_pad) take
    2; a 960x540 frame (254 bands) takes 1; every power of two is reached,
    n_pad caps and trims it, and fewer SMs take fewer slices."""
    def n_pad(n):
        return tsplat._round_up(n, tsplat._v2_block(n))

    assert n_pad(3000) == 3072 and band_slices(8, 3072) == 12
    assert band_slices(8, 128 * 20) == 10
    for n in (8192, 100_000, 500_000, tsplat.V2_MAX_N_PAD_FWD):
        assert band_slices(128, n_pad(n)) == 2
    assert band_slices(-(-960 * 540 // TP2), n_pad(100_000)) == 1
    assert [band_slices(b, 4096) for b in (198, 99, 50, 25, 24)] == [
        1, 2, 4, 8, 16]
    assert [band_slices(8, 128 * k) for k in (1, 2, 3, 4, 8, 16)] == [
        1, 2, 2, 4, 8, 16]
    assert band_slices(128, n_pad(100_000), sms=66) == 1

"""K6's tensor-core arithmetic (csrc/splat_v2_bwd.cu), emulated without a
card, against its plain twin `kernels.splat_v2.v2_bwd_plain`, which the
port's parity tests hold to the TPU kernel.

The emulation does what the kernel does, for each nb-block of gaussians
and each of the kernel's pixel slices (2048 / slices consecutive pixels of
every band whose block range holds the block, bands in order, staged in
pieces of up to 256 pixels):
- log2(e) folded into the pre-scaled conic (a', b', c' of K5's staging),
  the row terms b' dy and c' dy^2 once per gaussian and row segment (the
  pixels of one frame row inside one piece), e = fma(dx, fma(a', dx,
  b' dy), c' dy^2) and x = 2^e;
- each operand of a product split as x = big + small (big = x with its 13
  low mantissa bits cleared, small read by the tensor core to TF32), the
  three products big.big' + big.small' + small.big' exact (f64) and
  rounded to f32 at each accumulator restart: g_x = featsop . g8 per step
  of 8 pixels, g_featop = x . g8 per row segment, added into an f32 total
  in segment order;
- per lane t of a gaussian (pixels 8 k + 2t and 8 k + 2t + 1 of each step
  k of a segment; pixels past the segment's end count 0) the segment sums
  of g_e = x g_x, g_e dx and g_e dx^2 in f32 in pixel order, folded into
  the running moments at each segment's end (Mdx += S1, Mxx += S2, Mdy =
  fma(dy, S0, Mdy), Mxy = fma(dy, S1, Mxy), Myy = fma(dy dy, S0, Myy));
- the 4 lanes by the kernel's butterfly ((t0 + t1) + (t2 + t3)), then the
  slices' rows added in slice order.

Tolerance: K6's against its twin on the card (chip_smoke.py,
tests/test_torch_port_cuda.py): rtol 2e-4, and atol 2e-5 times the largest
magnitude of the output column (at least 1), on an N(0, 1) cotangent in
the five feature rows of the frame's pixels. The same check fails with the
small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import splat_v2
from tpu_gaussians_torch.ops import splat as tsplat

from .test_torch_port_binned_bwd_tc import fma, product
from .test_torch_port_cuda import (assert_moments_close, splat_inputs,
                                   synthetic_splats)

TP2 = 2048            # pixels per band
PIECE = 256           # pixels staged at a time
LOG2E = np.float32(1.4426950408889634)
# csrc/splat_v2_bwd.cu's slice rule: up to MAX_SLICES, BLOCKS_PER_SM blocks
# of KG gaussians per SM.
KG, MAX_SLICES, BLOCKS_PER_SM = 128, 16, 4
H100_SMS = 132


def pixel_slices(n_pad, sms=H100_SMS):
    """The kernel's rule (csrc/splat_v2_bwd.cu:pixel_slices), from host
    shapes: the fewest slices (1, 2, 4, 8, 16) that give the grid of
    n_pad / 128 gaussian blocks BLOCKS_PER_SM blocks per SM."""
    blocks, slices = n_pad // KG, 1
    while slices < MAX_SLICES and blocks * slices < BLOCKS_PER_SM * sms:
        slices *= 2
    return slices


def segment(rows, g8, q0, q_end, width, small):
    """One row segment [q0, q_end) of a row for the gaussian rows `rows`:
    (dy, S0, S1, S2 per lane (m, 4), g_featop over the segment (m, 8))."""
    row = q0 // width
    px, py = rows[:, 0:1], rows[:, 1:2]
    ah, bh, ch = (LOG2E * rows[:, c:c + 1] for c in (2, 3, 4))
    n = q_end - q0
    steps = -(-n // 8)
    xs = torch.arange(q0 - row * width, q0 - row * width + 8 * steps,
                      dtype=torch.float32) + np.float32(0.5)
    valid = torch.arange(8 * steps) < n
    gb = torch.zeros((8, 8 * steps))
    gb[:, :n] = g8[:, q0:q_end]
    dy = np.float32(row + 0.5) - py                        # (m, 1)
    bdy, cdy2 = bh * dy, (ch * dy) * dy
    dx = xs[None, :] - px                                  # (m, 8 steps)
    ex = torch.exp2(fma(dx, fma(ah, dx, bdy), cdy2)) * valid
    gx = product(rows[:, 6:14], gb, small)
    ge = ex * gx
    u = ge * dx
    m = rows.shape[0]
    # (gaussian, step, lane t, pixel 2t + e)
    ge_l, u_l, dx_l = (a.reshape(m, steps, 4, 2) for a in (ge, u, dx))
    s0, s1, s2 = (torch.zeros((m, 4)) for _ in range(3))
    for k in range(steps):
        for e in range(2):
            s0 = s0 + ge_l[:, k, :, e]
            s1 = s1 + u_l[:, k, :, e]
            s2 = fma(u_l[:, k, :, e], dx_l[:, k, :, e], s2)
    return dy, s0, s1, s2, product(ex, gb.T, small)


def k6_emulated(lo, cnt, gdata, g8, width, nb, slices, small=True):
    """K6's rows as the kernel forms them, with `slices` pixel slices."""
    n_pad = gdata.shape[0]
    length = TP2 // slices
    part = torch.zeros((slices, n_pad, 16))
    lo, cnt = lo.tolist(), cnt.tolist()
    for blk in range(n_pad // nb):
        bands = [i for i, (l, c) in enumerate(zip(lo, cnt))
                 if l <= blk < l + c]
        rows = gdata[blk * nb:(blk + 1) * nb]
        for s in range(slices):
            mom = torch.zeros((5, nb, 4))     # mdx, mdy, mxx, mxy, myy
            gfeat = torch.zeros((nb, 8))
            for band in bands:
                for off in range(0, length, PIECE):
                    p0 = band * TP2 + s * length + off
                    p_end = p0 + min(PIECE, length - off)
                    q0 = p0
                    while q0 < p_end:
                        q_end = min(p_end, (q0 // width + 1) * width)
                        dy, s0, s1, s2, racc = segment(rows, g8, q0, q_end,
                                                       width, small)
                        mom[0] += s1
                        mom[2] += s2
                        mom[1] = fma(dy, s0, mom[1])
                        mom[3] = fma(dy, s1, mom[3])
                        mom[4] = fma(dy * dy, s0, mom[4])
                        gfeat = gfeat + racc
                        q0 = q_end
            lanes = (mom[..., 0] + mom[..., 1]) + (mom[..., 2] + mom[..., 3])
            part[s, blk * nb:(blk + 1) * nb, :5] = lanes.T
            part[s, blk * nb:(blk + 1) * nb, 6:14] = gfeat
    out = part[0]
    for s in range(1, slices):
        out = out + part[s]
    return out


# Staged cases (general conics, one gaussian in ten at zero opacity): the
# flagship EWA accum fit's shape (3,000 gaussians at 128x128: n_pad 3072,
# the rule's 16 slices of one row each); a width that does not divide a band
# (bands and pieces end mid-row, segments of no multiple of 8 pixels); a
# one-row frame; bands whose range is empty (every centre in the top rows).
CASES = {
    "flagship_shape": (dict(n=3000, height=128, width=128), 16),
    "ragged_width_slices1": (dict(n=1000, height=48, width=200), 1),
    "ragged_width_slices4": (dict(n=1000, height=48, width=200), 4),
    "one_row_slices2": (dict(n=300, height=1, width=700), 2),
    "empty_bands_slices8": (dict(n=700, height=256, width=96, y_max=60.0,
                                 sigma_max=3.0), 8),
}


def case_inputs(case, seed=4):
    """(lo, cnt, gdata, g8, hw_pad, width, nb) staged by ops/splat._v2_prep
    from seeded columns, and the slices: the cotangent N(0, 1) in the five
    feature rows of the frame's pixels, zero elsewhere (as the backward
    stages it)."""
    kw, slices = CASES[case]
    kw = dict(kw)
    n, height, width = kw.pop("n"), kw.pop("height"), kw.pop("width")
    cols = list(synthetic_splats(n, height, width, seed=seed, **kw))
    rng = np.random.default_rng(seed + 1)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    st = tsplat._v2_prep(tsplat.y_sorted(splat_inputs(cols)), height, width)
    g8 = torch.zeros((8, st.hw_pad))
    g8[:5, :height * width] = torch.from_numpy(rng.normal(
        size=(5, height * width)).astype(np.float32))
    return (st.lo, st.cnt, st.gdata, g8, st.hw_pad, width, st.nb), slices


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_tf32_split_arithmetic_matches_twin(case):
    """K6's arithmetic against the twin at K6's tolerance, on each case with
    the slice count it names; the rows of blocks that no band reaches, and
    columns 5, 14 and 15, are exactly zero."""
    (lo, cnt, gdata, g8, hw_pad, width, nb), slices = case_inputs(case)
    got = k6_emulated(lo, cnt, gdata, g8, width, nb, slices)
    ref = splat_v2.v2_bwd_plain(lo, cnt, gdata, g8, hw_pad, width, nb)
    assert_moments_close(got.numpy(), ref.numpy())
    assert not got[:, [5, 14, 15]].any()
    reached = torch.zeros(gdata.shape[0] // nb, dtype=torch.bool)
    for l, c in zip(lo.tolist(), cnt.tolist()):
        reached[l:l + c] = True
    assert not got.reshape(-1, nb, 16)[~reached].any()
    if case.startswith("empty_bands"):
        assert (cnt == 0).any()


def test_k6_without_small_products_fails_the_check():
    """The same check fails with one TF32 product (on a ragged width in 4
    slices; each case does): the split's small terms are what keeps K6
    within its tolerance."""
    (lo, cnt, gdata, g8, hw_pad, width, nb), slices = case_inputs(
        "ragged_width_slices4")
    got = k6_emulated(lo, cnt, gdata, g8, width, nb, slices, small=False)
    ref = splat_v2.v2_bwd_plain(lo, cnt, gdata, g8, hw_pad, width, nb)
    with pytest.raises(AssertionError):
        assert_moments_close(got.numpy(), ref.numpy())


def test_pixel_slices_rule_at_the_cells_shapes():
    """The rule's slices on an H100 (132 SMs) at the shapes K6 meets: the
    flagship EWA accum fit (capacity 3000: n_pad 3072) and the 8,192-
    gaussian kernel case take 16 slices, the 100k 512x512 scene on the
    dense route and the route's largest n_pad one; every count the rule can
    pick is reached, and fewer SMs take fewer slices."""
    def n_pad(n):
        return tsplat._round_up(n, tsplat._v2_block(n))

    assert n_pad(3000) == 3072 and pixel_slices(3072) == 16
    assert pixel_slices(n_pad(8192)) == 16
    assert pixel_slices(n_pad(100_000)) == 1
    assert pixel_slices(tsplat.V2_MAX_N_PAD_BWD) == 1
    assert [pixel_slices(KG * b) for b in (528, 264, 132, 66, 65)] == [
        1, 2, 4, 8, 16]
    assert pixel_slices(KG * 264, sms=66) == 1

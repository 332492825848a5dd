"""K2's tensor-core arithmetic (csrc/splat_sep_bwd.cu), emulated without a
card, against its plain twin `kernels.splat_sep.sep_bwd_plain`, which the
port's parity tests hold to the TPU kernel.

The emulation does what the kernel does, per slice (a 32-row half of every
band times a range of 64-column strips), walking the bands in order:
- Ey per band and Ex per strip in f32; each operand of a product split as
  x = big + small (big = x with its 13 low mantissa bits cleared, small
  read by the tensor core to TF32); the three products big.big' +
  big.small' + small.big' exact (f64) and rounded to f32 at each
  accumulator restart:
  P1  gG = gband . Ex over one strip's 64 columns, added into an f32 total
      in strip order;
  P2  H_f = gband_f^T . Ey over one feature's 32 rows, then gEx = sum_f
      featsop_f H_f by f32 multiply-adds in feature order;
- Mdx, Mxx per lane: u = gEx Ex, t1 = u tx, added over the lane's columns
  (column 16n + 8h + 2t + e: task n, warp half h, lane t, parity e) in
  (band, strip, n, e) order, then over the 4 lanes ((t0 + t1) + (t2 +
  t3)) and the 2 halves;
- g_featop, Mdy, Myy at each band's end from the band's gG, per lane over
  its rows 8w + 2t, + 1, then over the lanes as above, added per warp in
  band order, then over the 4 warps in order;
- the slices' rows added in slice order.

Tolerance: K2's against its twin on the card (chip_smoke.py,
tests/test_torch_port_cuda.py): rtol 2e-4, and atol 2e-5 times the
largest magnitude of the output column (at least 1): on the parity inputs
of tests/test_torch_port_splat.py, and on one heavy band of the 100k
512x512 scene's shape (R 32, Wp 512: 8 strips) whose gaussians are up to
30 pixels wide, beyond that scene's 1-5, so that each sum runs over up to
~180 columns and all 32 rows (Mdx up to about 3,700, Mxx 156,000), with
the slicing the kernel gives it (4 slices of 2 strips), 2 slices of 4
strips and one slice (the 100k scene's). The emulation's largest
error is 1-2.5% of the tolerance. The same check with the small products
dropped (one TF32 product) fails: its largest error is 20 times the
tolerance on the heavy band and 11-17 times on the parity inputs.
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import splat_sep
from tpu_gaussians_torch.ops import splat as TS

from .test_torch_port_cuda import (assert_moments_close, splat_inputs,
                                   synthetic_splats)
from .test_torch_port_splat import CASES, IDS
from .test_torch_port_splat_sep_tc import heavy_band as heavy_sep_band

SUB, COLS, KC = 32, 64, 64   # rows, columns and gaussians of a block
TARGET_BLOCKS = 264           # csrc/splat_sep_bwd.cu's


def k2_slicing(rows, wp, n_pad):
    """(column slices, strips per slice, slices): the kernel's rule
    (csrc/splat_sep_bwd.cu:slicing) from host shapes."""
    base = (n_pad // KC) * (rows // SUB)
    strips = wp // COLS
    want = 1 if base >= TARGET_BLOCKS else -(-TARGET_BLOCKS // base)
    cols = min(want, strips)
    per = -(-strips // cols)
    cols = -(-strips // per)
    return cols, per, (rows // SUB) * cols


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared (the TF32 part)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def product(a, b, small=True):
    """a @ b as the kernel's restarted accumulator gives it: the three TF32
    products exact (f64), rounded to f32 once; small=False keeps only
    big.big'."""
    ab, bb = tf32(a), tf32(b)
    out = ab.double() @ bb.double()
    if small:
        out += (tf32(a - ab).double() @ bb.double()
                + ab.double() @ tf32(b - bb).double())
    return out.float()


def fma(a, b, c):
    """f32 fmaf(a, b, c), through f64."""
    return (a.double() * b.double() + c.double()).float()


def quad(v):
    """The sum over the 4 lanes of a fragment row (dim -2 of v), as the
    kernel's two xor shuffles form it."""
    return (v[..., 0, :] + v[..., 1, :]) + (v[..., 2, :] + v[..., 3, :])


def k2_emulated(lo, cnt, gdata, gband, rows, wp, nb, slicing=None,
                small=True):
    """K2's rows as the kernel forms them, with `slicing` (column slices,
    strips per slice, slices; by default the kernel's rule)."""
    n_pad = gdata.shape[0]
    col_slices, per, slices = slicing or k2_slicing(rows, wp, n_pad)
    strips = wp // COLS
    parts = []
    for sl in range(slices):
        sub, cs = divmod(sl, col_slices)
        sdx = torch.zeros((2, 4, n_pad))      # (warp half, lane t, gaussian)
        sxx = torch.zeros((2, 4, n_pad))
        bq = torch.zeros((4, 7, n_pad))       # (warp, quantity, gaussian)
        for band, s, e in splat_sep._ranges(lo, cnt, nb):
            gd = gdata[s:e]
            px, py, a2, c2 = gd[:, 0], gd[:, 1], gd[:, 2], gd[:, 4]
            fo = gd[:, 6:11].T
            yr = (band * rows + sub * SUB
                  + torch.arange(SUB, dtype=torch.int32)).float() + 0.5
            ty = yr[:, None] - py
            ey = torch.exp(c2 * (ty * ty))                    # (32, m)
            gb_band = gband[band, :, sub * SUB:(sub + 1) * SUB]  # (5, 32, wp)
            run = torch.zeros((5 * SUB, e - s))
            for strip in range(cs * per, min(cs * per + per, strips)):
                cols = strip * COLS + torch.arange(COLS, dtype=torch.int32)
                tx = (cols.float() + 0.5)[:, None] - px
                ex = torch.exp(a2 * (tx * tx))                # (64, m)
                gb = gb_band[:, :, cols.long()]               # (5, 32, 64)
                run = run + product(gb.reshape(5 * SUB, COLS), ex, small)
                h = [product(gb[f].T, ey, small) for f in range(5)]
                gex = h[0] * fo[0]
                for f in range(1, 5):
                    gex = fma(h[f], fo[f], gex)
                t1 = ((gex * ex) * tx).reshape(4, 2, 4, 2, -1)  # n, h, t, e
                txv = tx.reshape(4, 2, 4, 2, -1)
                for n in range(4):
                    for par in range(2):
                        v, x = t1[n, :, :, par], txv[n, :, :, par]
                        sdx[:, :, s:e] = sdx[:, :, s:e] + v
                        sxx[:, :, s:e] = fma(v, x, sxx[:, :, s:e])
            # The band's end: row 8w + 2t + par of lane t of warp w.
            g_g = run.reshape(5, 4, 4, 2, -1)
            eyv, tyv = ey.reshape(4, 4, 2, -1), ty.reshape(4, 4, 2, -1)
            q = [None] * 7
            for par in range(2):
                v, ye, yt = g_g[:, :, :, par], eyv[:, :, par], tyv[:, :, par]
                gey = v[0] * fo[0]
                for f in range(1, 5):
                    gey = fma(v[f], fo[f], gey)
                t2 = (gey * ye) * yt
                for f in range(5):
                    q[f] = v[f] * ye if par == 0 else fma(v[f], ye, q[f])
                q[5] = t2 if par == 0 else q[5] + t2
                q[6] = t2 * yt if par == 0 else fma(t2, yt, q[6])
            bq[:, :, s:e] = bq[:, :, s:e] + quad(torch.stack(q, dim=1))
        v = ((bq[0] + bq[1]) + bq[2]) + bq[3]
        row = torch.zeros((n_pad, 16))
        row[:, 0] = quad(sdx[0]) + quad(sdx[1])
        row[:, 1] = v[5]
        row[:, 2] = quad(sxx[0]) + quad(sxx[1])
        row[:, 4] = v[6]
        row[:, 6:11] = v[:5].T
        parts.append(row)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def heavy_band():
    """The heavy band of the K1 test's generator at the 100k scene's shape
    (R 32, Wp 512) under 4096 gaussians, sigma_x 0.8-30 pixels and sigma_y
    0.8-12, and an N(0,1) cotangent: (lo, cnt, gdata, gband, rows, wp,
    nb)."""
    lo, cnt, gdata, rows, wp, nb = heavy_sep_band(
        4096, 128, 512, seed=17, sigma_x=(0.8, 30.0), sigma_y=(0.8, 12.0))
    gband = torch.from_numpy(np.random.default_rng(17).normal(
        size=(1, 5, rows, wp)).astype(np.float32))
    return lo, cnt, gdata, gband, rows, wp, nb


def parity_case(case):
    """The staged inputs of one parity case and an N(0,1) cotangent."""
    n, height, width = CASES[IDS.index(case)]
    _, (lo, cnt, gdata, nb, wp, _, n_bands, rows) = TS.stage(
        splat_inputs(synthetic_splats(n, height, width, seed=n)), height,
        width)
    gband = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n_bands, 5, rows, wp)).astype(np.float32))
    return lo, cnt, gdata, gband, rows, wp, nb


HEAVY = {"heavy_rule": None, "heavy_2x4": (2, 4, 2), "heavy_1x8": (1, 8, 1)}
# The slices the kernel's rule gives each input with no slicing given.
RULE_SLICES = {"300_64x64": 4, "5000_200x136": 4, "20000_96x128": 1,
               "heavy_rule": 4}


@pytest.mark.parametrize("case", [*IDS, *HEAVY])
def test_k2_tf32_split_arithmetic_matches_twin(case):
    """K2's arithmetic against the twin at K2's tolerance, rtol 2e-4 +
    2e-5 x the column's largest magnitude: on the parity inputs (R 64 and
    32, several bands, 4, 4 and 1 slices by the kernel's rule), and on the
    heavy band with the rule's slicing (4 slices of 2 strips), 2 slices of
    4 and one slice of all 8 strips (the 100k scene's)."""
    if case in HEAVY:
        args, slicing = heavy_band(), HEAVY[case]
    else:
        args, slicing = parity_case(case), None
    if slicing is None:
        lo, cnt, gdata, gband, rows, wp, nb = args
        assert k2_slicing(rows, wp, gdata.shape[0])[2] == RULE_SLICES[case]
    got = k2_emulated(*args, slicing=slicing)
    ref = splat_sep.sep_bwd_plain(*args)
    if case in HEAVY:
        assert float(ref[:, 0].abs().max()) > 1000   # Mdx: long sums
    assert_moments_close(got.numpy(), ref.numpy())


def test_k2_without_small_products_fails_the_check():
    """The same check on the heavy band fails with one TF32 product: the
    split's small terms are what keep K2 within its tolerance."""
    args = heavy_band()
    got = k2_emulated(*args, slicing=HEAVY["heavy_2x4"], small=False)
    ref = splat_sep.sep_bwd_plain(*args)
    scale = torch.clamp(ref.abs().amax(dim=0), min=1.0)
    err = ((got - ref).abs() / (2e-4 * ref.abs() + 2e-5 * scale)).max()
    assert float(err) > 10

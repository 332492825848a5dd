"""K1's tensor-core arithmetic (csrc/splat_sep_fwd.cu), emulated without a
card, against its plain twin `kernels.splat_sep.sep_fwd_plain`, which the
port's parity tests hold to the TPU kernel.

The emulation does what the kernel does: per band, G = featsop_f x Ey and
Ex in f32; each operand split as x = big + small (big = x with its 13 low
mantissa bits cleared, small read by the tensor core to TF32); the three
products big.big' + big.small' + small.big' exact (f64) and summed over a
64-gaussian chunk, rounded to f32 once a chunk; the chunk partials added
into an f32 total in chunk order within a slice of the band's range, and
the slice totals added in slice order.

Tolerance: rtol 1e-5 / atol 1e-5, K1's against its twin on the card
(chip_smoke.py, tests/test_torch_port_cuda.py): on the parity inputs of
tests/test_torch_port_splat.py, and on one heavy band of about 40,000
gaussians whose sums reach the 100k-gaussian 512x512 scene's (up to about
40 in the plane of ones and 100 in z at its initial parameters). The same
check fails with the small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import splat_sep
from tpu_gaussians_torch.ops import splat as TS

from .test_torch_port_cuda import splat_inputs, synthetic_splats
from .test_torch_port_splat import CASES, IDS

KC = 64            # gaussians per chunk (the mma accumulator's restart)
# K1's slice length at the parity sizes: its least, MIN_SLICE (the rule,
# csrc/splat_sep_fwd.cu:slice_len, asks for less there).
PARITY_SLICE = 128


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: the TF32 part of an f32
    value, as K1 forms it and as the tensor core reads an f32 register."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def k1_emulated(lo, cnt, gdata, rows, wp, nb, length, small=True):
    """K1's sums as the kernel forms them, with slices of `length`
    gaussians; small=False keeps only the big.big' product."""
    out = torch.zeros((lo.shape[0], splat_sep.FEAT, rows, wp))
    for band, start, end in splat_sep._ranges(lo, cnt, nb):
        end = min(end, gdata.shape[0])
        _, ex, _, _, _, g_mat = splat_sep._band_factors(gdata[start:end],
                                                        band, rows, wp)
        a = g_mat.reshape(splat_sep.FEAT * rows, -1)     # (5R, k)
        parts = []
        for s in range(0, end - start, length):
            total = torch.zeros((splat_sep.FEAT * rows, wp))
            s_end = min(s + length, end - start)
            for c in range(s, s_end, KC):
                ga = a[:, c:min(c + KC, s_end)]
                eb = ex[:, c:min(c + KC, s_end)].T
                gb, xb = tf32(ga), tf32(eb)
                prod = gb.double() @ xb.double()
                if small:
                    prod += (tf32(ga - gb).double() @ xb.double()
                             + gb.double() @ tf32(eb - xb).double())
                total += prod.float()
            parts.append(total)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[band] = acc.reshape(splat_sep.FEAT, rows, wp)
    return out


def heavy_band(n=40_064, nb=128, width=128, seed=13, sigma_x=(0.8, 1.8),
               sigma_y=(0.8, 1.8)):
    """One band of 32 rows and width columns under n gaussians (sigmas in
    pixels drawn from the ranges given, centres over the band and 10
    pixels around it, y-sorted): (lo, cnt, gdata, rows, wp, nb); n a
    multiple of nb."""
    rng = np.random.default_rng(seed)
    low, high = np.array([sigma_x, sigma_y]).T[:, :, None]
    sx, sy = rng.uniform(low, high, (2, n))
    op = rng.uniform(0.2, 0.9, n)
    feats = np.concatenate([rng.uniform(0, 1, (n, 3)), np.ones((n, 1)),
                            rng.uniform(1, 4, (n, 1))], axis=1)
    gd = np.zeros((n, 16), np.float32)
    gd[:, 0] = rng.uniform(-10, width + 10, n)
    gd[:, 1] = np.sort(rng.uniform(-10, 42, n))
    gd[:, 2], gd[:, 4] = -0.5 / sx ** 2, -0.5 / sy ** 2
    gd[:, 5] = op
    gd[:, 6:11] = feats * op[:, None]
    lo = torch.zeros(1, dtype=torch.int32)
    cnt = torch.full((1,), n // nb, dtype=torch.int32)
    return lo, cnt, torch.from_numpy(gd), 32, width, nb


def parity_case(case):
    n, height, width = CASES[IDS.index(case)]
    _, (lo, cnt, gdata, nb, wp, _, _, rows) = TS.stage(
        splat_inputs(synthetic_splats(n, height, width, seed=n)), height,
        width)
    return lo, cnt, gdata, rows, wp, nb


@pytest.mark.parametrize("case", [*IDS, "heavy_40064_nb128_len128",
                                  "heavy_40064_nb128_len3136",
                                  "heavy_40000_nb64_len3136"])
def test_k1_tf32_split_arithmetic_matches_twin(case):
    """K1's arithmetic against the twin at K1's tolerance, rtol 1e-5 /
    atol 1e-5: on the parity inputs with the kernel's slice length, and on
    the heavy band with the flagship's slice length (128: 313 slices) and
    about the 100k scene's (3136: 13 slices, the last one partial; also at
    nb 64, the least K1 takes)."""
    if case.startswith("heavy"):
        n, nb, length = (int(v) for v in case.replace("nb", "").replace(
            "len", "").split("_")[1:])
        args = heavy_band(n, nb)
    else:
        args, length = parity_case(case), PARITY_SLICE
    got = k1_emulated(*args, length)
    ref = splat_sep.sep_fwd_plain(*args)
    if case.startswith("heavy"):
        assert 30 < float(ref[0, 3].max()) < 60
        assert 70 < float(ref[0, 4].max()) < 150
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_k1_without_small_products_fails_the_check():
    """The same check on the heavy band fails with one TF32 product: the
    split's small terms are what keeps K1 within 1e-5."""
    args = heavy_band()
    got = k1_emulated(*args, 3136, small=False)
    ref = splat_sep.sep_fwd_plain(*args)
    assert not torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
    err = ((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max()
    assert float(err) > 10


@pytest.mark.parametrize("wp,nb", [(96, 128), (128, 32)])
def test_k1_refuses_shapes_off_its_grid(wp, nb):
    """K1 (wrapper and twin alike, on any device) takes Wp and nb in
    multiples of 64, its column strip and gaussian chunk, which the staging
    always gives (multiples of 128); so does K2, whose strips and chunks
    are 64 wide too."""
    lo, cnt, gdata, rows, _, _ = parity_case(IDS[0])
    for fn in (splat_sep.splat_sep_fwd, splat_sep.sep_fwd_plain):
        with pytest.raises(ValueError, match="multiples of 64"):
            fn(lo, cnt, gdata, rows, wp, nb)
    gband = torch.zeros((lo.shape[0], splat_sep.FEAT, rows, wp))
    for fn in (splat_sep.splat_sep_bwd, splat_sep.sep_bwd_plain):
        with pytest.raises(ValueError, match="multiples of 64"):
            fn(lo, cnt, gdata, gband, rows, wp, nb)

"""K8a's tensor-core arithmetic (csrc/binned_fwd.cu), emulated without a
card, against its plain twin `kernels.binned.binned_fwd_plain`, which the
port's parity tests hold to the TPU kernel.

The emulation does what the kernel does: per tile, log2(e) folded into the
conic and w = 2^e; op folded into the feature rows; each operand split as
x = big + small (big = x with its 13 low mantissa bits cleared, small read
by the tensor core to TF32); the three products big.big' + big.small' +
small.big' exact (f64) and summed over a 128-slot chunk, rounded to f32
once a chunk; the chunk partials added into an f32 total in chunk order
within a slice of the tile's list (the slice stops at cnt rounded up to
128 slots), and the slice totals added in slice order.

Tolerance: rtol 1e-5 / atol 1e-5, K8a's against its twin on the card
(chip_smoke.py, tests/test_torch_port_cuda.py): on the lists of
tests/test_torch_port_ewa_accum.py, and on one heavy tile of 8,192 slots
whose sums reach those of the 100k-gaussian 512x512 EWA scene (up to
about 39 in the row of ones and 101 in z at its initial parameters, view
0, by tools/ab_k8a.py; 122 after chip_smoke's 10 steps). The same check
fails with the small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import binned
from tpu_gaussians_torch.kernels.sorted_fwd import tile_pixels
from tpu_gaussians_torch.kernels.splat_v2 import EXP_FLOOR
from tpu_gaussians_torch.ops.binning import TPS

from .test_torch_port_cuda import TILES_X, synthetic_lists

CHUNK = 128        # slots per chunk (the mma accumulator's restart)
LOG2E = 1.4426950408889634
# K8a's slice lengths (csrc/binned_fwd.cu:slice_len): 128 on the 2x2-tile
# lists at cap 1024 and on the flagship's 8 tiles at cap 8192, 1024 on the
# 100k scene's 128 tiles at cap 8192.
LISTS_SLICE, FLAGSHIP_SLICE, SCENE_SLICE = 128, 128, 1024


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: the TF32 part of an f32
    value, as K8a forms it and as the tensor core reads an f32 register."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def k8a_emulated(gdense, cnt, tiles_x, length, small=True):
    """K8a's sums as the kernel forms them, with slices of `length` slots;
    small=False keeps only the big.big' product."""
    n_tiles = cnt.shape[0]
    cap = gdense.shape[0] // n_tiles
    g = gdense.reshape(n_tiles, cap, 16)
    gx, gy = tile_pixels(n_tiles, tiles_x, "cpu")
    out = torch.zeros((8, n_tiles, TPS))
    for t in range(n_tiles):
        end = -(-min(max(int(cnt[t]), 0), cap) // CHUNK) * CHUNK
        parts = []
        for s in range(0, max(end, 1), length):      # slice 0 at least
            total = torch.zeros((8, TPS))
            for c in range(s, min(s + length, end), CHUNK):
                rows = g[t, c:c + CHUNK]
                ah = (-0.5 * LOG2E) * rows[:, 2:3]
                bh = -LOG2E * rows[:, 3:4]
                ch = (-0.5 * LOG2E) * rows[:, 4:5]
                dx = gx[t][None, :] - rows[:, 0:1]
                dy = gy[t][None, :] - rows[:, 1:2]
                e = dx * (ah * dx + bh * dy) + (ch * dy) * dy
                w = torch.exp2(torch.clamp(e, min=EXP_FLOOR * LOG2E))
                featop = rows[:, 6:14] * rows[:, 5:6]
                wb, fb = tf32(w), tf32(featop)
                prod = fb.double().T @ wb.double()
                if small:
                    prod += (tf32(featop - fb).double().T @ wb.double()
                             + fb.double().T @ tf32(w - wb).double())
                total += prod.float()
            parts.append(total)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[:, t] = acc
    return out.reshape(8, n_tiles * TPS)


def heavy_tile(count=8192, cap=8192, seed=17):
    """One tile (tiles_x 1) whose list holds `count` slots of a capacity
    `cap` (the rest the dead row: op 0, identity conic): sigmas 2-5 pixels
    with a general conic, centres over the tile and 20 pixels around it,
    opacities 0.2-0.9, feats [r, g, b, 1, z]. -> (gdense, cnt)."""
    rng = np.random.default_rng(seed)
    sx, sy = rng.uniform(2.0, 5.0, (2, count))
    gd = np.zeros((cap, 16), np.float32)
    gd[:, 2] = gd[:, 4] = 1.0
    rows = gd[:count]
    rows[:, 0] = rng.uniform(-20, 148, count)
    rows[:, 1] = rng.uniform(-20, 36, count)
    rows[:, 2], rows[:, 4] = 1.0 / sx ** 2, 1.0 / sy ** 2
    rows[:, 3] = rng.uniform(-0.9, 0.9, count) * np.sqrt(rows[:, 2]
                                                         * rows[:, 4])
    rows[:, 5] = rng.uniform(0.2, 0.9, count)
    rows[:, 6:9] = rng.uniform(0, 1, (count, 3))
    rows[:, 9] = 1.0
    rows[:, 10] = rng.uniform(1.0, 4.0, count)
    return torch.from_numpy(gd), torch.tensor([count], dtype=torch.int32)


CASES = {
    "ewa_accum_lists": ((1024, 600, 0, 300), LISTS_SLICE),
    "chunk_edges": ((1, 512, 513, 1024), LISTS_SLICE),
    "heavy_8192_len128": (8192, FLAGSHIP_SLICE),
    "heavy_8192_len1024": (8192, SCENE_SLICE),
    "heavy_7000_len1024": (7000, SCENE_SLICE),
}


def case_inputs(case):
    cnt, length = CASES[case]
    if case.startswith("heavy"):
        return (*heavy_tile(cnt), 1), length
    return (*synthetic_lists(False, cnt=cnt), TILES_X), length


@pytest.mark.parametrize("case", sorted(CASES))
def test_k8a_tf32_split_arithmetic_matches_twin(case):
    """K8a's arithmetic against the twin at K8a's tolerance, rtol 1e-5 /
    atol 1e-5: on the EWA accumulation parity lists (a full tile, a partial
    second chunk, an empty tile, counts on either side of a 512-slot chunk
    edge) and on the heavy tile with the flagship's slice length (128: 64
    slices) and the 100k scene's (1024: 8 slices, and 7 with the last one
    partial and its last chunk ending past cnt)."""
    (gdense, cnt, tiles_x), length = case_inputs(case)
    got = k8a_emulated(gdense, cnt, tiles_x, length)
    ref = binned.binned_fwd_plain(gdense, cnt, tiles_x)
    if case.startswith("heavy"):
        assert 30 < float(ref[3].max()) < 60
        assert 70 < float(ref[4].max()) < 150
    if case == "ewa_accum_lists":
        assert not got.reshape(8, 4, TPS)[:, 2].any()   # the empty tile
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_k8a_without_small_products_fails_the_check():
    """The same check on the heavy tile fails with one TF32 product: the
    split's small terms are what keeps K8a within 1e-5."""
    gdense, cnt = heavy_tile()
    got = k8a_emulated(gdense, cnt, 1, SCENE_SLICE, small=False)
    ref = binned.binned_fwd_plain(gdense, cnt, 1)
    assert not torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
    err = ((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max()
    assert float(err) > 10

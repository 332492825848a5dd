"""K8b's tensor-core arithmetic (csrc/binned_bwd.cu), emulated without a
card, against its plain twin `kernels.binned.binned_bwd_plain`, which the
port's parity tests hold to the TPU kernel.

The emulation does what the kernel does, per tile, for the warps whose 32
slots start below cnt (the rest give zero rows):
- log2(e) folded into the conic, the row terms b dy and c dy^2 once per
  slot and row, e = fma(dx, fma(a', dx, b dy), c dy^2) and exp(e) = 2^e;
- op factored out: v = exp(e) g_w, the sums of v, v dx, v dx^2 and
  exp(e) g8, times op once at the end;
- each operand of a product split as x = big + small (big = x with its 13
  low mantissa bits cleared, small read by the tensor core to TF32), the
  three products big.big' + big.small' + small.big' exact (f64) and
  rounded to f32 at each accumulator restart: g_w = feats . g8 per step
  of 8 pixels, g_feat / op = exp(e) . g8 per tile row, added into an f32
  total in row order;
- per lane t of a slot (its pixels 8 s + 2t and 8 s + 2t + 1 of each step
  s of a row) the row sums of v, v dx and v dx^2 in f32 in pixel order,
  folded into the running moments at each row's end (M0 += S0, Mdx += S1,
  Mxx += S2, Mdy = fma(dy, S0, Mdy), Mxy = fma(dy, S1, Mxy), Myy =
  fma(dy dy, S0, Myy)), over the rows of the lane's pixel slice in order;
- the slices' partials added in slice order, then the 4 lanes by the
  kernel's butterfly ((t0 + t1) + (t2 + t3)).

Tolerance: K8b's against its twin on the card (chip_smoke.py,
tests/test_torch_port_cuda.py): rtol 2e-4, and atol 2e-5 times the largest
magnitude of the output column (at least 1), on an N(0, 1) cotangent: on
the lists of tests/test_torch_port_ewa_accum.py and on one full tile of
8,192 slots (tests/test_torch_port_binned_tc.heavy_tile: sigmas 2-5
pixels, a general conic), with each of the kernel's pixel slicings (1
slice: the 100k 512x512 EWA scene's 128 tiles; 2; 4: the flagship's 8
tiles and every grid of under 512 blocks). The same check fails with the
small products dropped (one TF32 product).
"""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.kernels import binned
from tpu_gaussians_torch.kernels.sorted_fwd import tile_pixels

from .test_torch_port_binned_tc import heavy_tile, tf32
from .test_torch_port_cuda import (TILES_X, assert_moments_close,
                                   synthetic_lists)

WS = 32               # slots per warp
ROWS, COLS = 16, 128  # a tile's rows and columns
LOG2E = np.float32(1.4426950408889634)
TARGET_BLOCKS = 2048  # csrc/binned_bwd.cu's


def pixel_slices(n_tiles, cap):
    """The kernel's rule (csrc/binned_bwd.cu:pixel_slices), from host
    shapes: the fewest slices (1, 2, 4) that give about TARGET_BLOCKS
    blocks of 128 / slices slots."""
    blocks, slices = n_tiles * (cap // 128), 1
    while slices < 4 and blocks * slices < TARGET_BLOCKS:
        slices *= 2
    return slices


def product(a, b, small=True):
    """a @ b as a restarted tensor-core accumulator gives it: the three
    TF32 products exact (f64), rounded to f32 once; small=False keeps only
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


def k8b_emulated(gdense, cnt, g8, tiles_x, slices, small=True):
    """K8b's rows as the kernel forms them, with `slices` pixel slices."""
    n_tiles = cnt.shape[0]
    cap = gdense.shape[0] // n_tiles
    g = gdense.reshape(n_tiles, cap, 16)
    g8t = g8.reshape(8, n_tiles, ROWS * COLS)
    gx, gy = tile_pixels(n_tiles, tiles_x, "cpu")
    out = torch.zeros((n_tiles, cap, 16))
    per = ROWS // slices
    for tile in range(n_tiles):
        live = min(max(int(cnt[tile]), 0), cap)
        end = -(-live // WS) * WS            # the warps that run
        if end == 0:
            continue
        rows = g[tile, :end]
        px, py = rows[:, 0:1], rows[:, 1:2]
        ah = (np.float32(-0.5) * LOG2E) * rows[:, 2:3]
        bh = -LOG2E * rows[:, 3:4]
        ch = (np.float32(-0.5) * LOG2E) * rows[:, 4:5]
        feats = rows[:, 6:14]
        dx = gx[tile, :COLS][None, :] - px                 # (m, 128)
        dxl = dx.reshape(end, COLS // 8, 4, 2)             # (step, t, pixel)
        total = None
        for q in range(slices):
            mom = torch.zeros((6, end, 4))   # m0, mdx, mdy, mxx, mxy, myy
            gfeat = torch.zeros((end, 8))
            for r in range(q * per, (q + 1) * per):
                gr = g8t[:, tile, r * COLS:(r + 1) * COLS]  # (8, 128)
                dy = gy[tile, r * COLS] - py                # (m, 1)
                bdy, cdy2 = bh * dy, (ch * dy) * dy
                ex = torch.exp2(fma(dx, fma(ah, dx, bdy), cdy2))
                gw = torch.cat([product(feats, gr[:, c:c + 8], small)
                                for c in range(0, COLS, 8)], dim=1)
                v = (ex * gw).reshape(end, COLS // 8, 4, 2)
                u = v * dxl
                s0, s1, s2 = (torch.zeros((end, 4)) for _ in range(3))
                for st in range(COLS // 8):
                    for e in range(2):
                        s0 = s0 + v[:, st, :, e]
                        s1 = s1 + u[:, st, :, e]
                        s2 = fma(u[:, st, :, e], dxl[:, st, :, e], s2)
                mom[0] += s0
                mom[1] += s1
                mom[3] += s2
                mom[2] = fma(dy, s0, mom[2])
                mom[4] = fma(dy, s1, mom[4])
                mom[5] = fma(dy * dy, s0, mom[5])
                gfeat = gfeat + product(ex, gr.T, small)
            total = (mom, gfeat) if total is None else (
                total[0] + mom, total[1] + gfeat)
        mom, gfeat = total
        lanes = (mom[..., 0] + mom[..., 1]) + (mom[..., 2] + mom[..., 3])
        op = rows[:, 5:6]
        m0, mdx, mdy, mxx, mxy, myy = lanes
        out[tile, :end, :6] = torch.stack(
            [mdx, mdy, mxx, mxy, myy, m0], dim=1) * op
        out[tile, :end, 6:14] = gfeat * op
    return out.reshape(n_tiles * cap, 16)


def cotangent(n_tiles, seed=3):
    """A seeded N(0, 1) cotangent g8 (8, n_tiles*2048), as the parity test
    of tests/test_torch_port_ewa_accum.py draws it."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(8, n_tiles * ROWS * COLS)).astype(np.float32))


CASES = {
    "ewa_accum_lists": ((1024, 600, 0, 300), None),
    "chunk_edges": ((1, 512, 513, 1024), None),
    "heavy_8192_slices1": (8192, 1),
    "heavy_8192_slices2": (8192, 2),
    "heavy_8192_slices4": (8192, 4),
    "heavy_7000_slices1": (7000, 1),
}


def case_inputs(case):
    cnt, slices = CASES[case]
    if case.startswith("heavy"):
        gdense, cnt_t = heavy_tile(cnt)
        return gdense, cnt_t, cotangent(1), 1, slices
    gdense, cnt_t = synthetic_lists(False, cnt=cnt)
    n_tiles = cnt_t.shape[0]
    return (gdense, cnt_t, cotangent(n_tiles), TILES_X,
            pixel_slices(n_tiles, gdense.shape[0] // n_tiles))


@pytest.mark.parametrize("case", sorted(CASES))
def test_k8b_tf32_split_arithmetic_matches_twin(case):
    """K8b's arithmetic against the twin at K8b's tolerance: on the EWA
    accumulation parity lists (a full tile, a partial second chunk, an
    empty tile, counts on either side of a 512-slot chunk edge; 4 slices by
    the kernel's rule) and on the full 8,192-slot tile with 1, 2 and 4
    pixel slices, and with 7,000 slots (the last warp's slots partly past
    cnt)."""
    gdense, cnt, g8, tiles_x, slices = case_inputs(case)
    got = k8b_emulated(gdense, cnt, g8, tiles_x, slices)
    ref = binned.binned_bwd_plain(gdense, cnt, g8, tiles_x)
    if case.startswith("heavy"):
        assert float(ref[:, 2].abs().max()) > 100    # Mxx's sums cancel
    n_tiles = cnt.shape[0]
    rows = got.reshape(n_tiles, -1, 16)
    for t, c in enumerate(cnt.tolist()):
        assert not rows[t, c:].any()
    assert_moments_close(got.numpy(), ref.numpy())


def test_k8b_without_small_products_fails_the_check():
    """The same check on the full tile fails with one TF32 product: the
    split's small terms are what keeps K8b within its tolerance."""
    gdense, cnt, g8, tiles_x, slices = case_inputs("heavy_8192_slices1")
    got = k8b_emulated(gdense, cnt, g8, tiles_x, slices, small=False)
    ref = binned.binned_bwd_plain(gdense, cnt, g8, tiles_x)
    with pytest.raises(AssertionError):
        assert_moments_close(got.numpy(), ref.numpy())


def test_pixel_slices_rule_at_the_cells_shapes():
    """The rule's slices at the shapes the kernel meets: the flagship EWA
    binned fit (8 tiles of cap 8192) and the card tests' 2x2 grid at cap
    1024 split each tile in 4, a 16-tile grid at cap 8192 in 2, the 100k
    512x512 scene (128 tiles of cap 8192) not at all."""
    assert pixel_slices(8, 8192) == 4
    assert pixel_slices(4, 1024) == 4
    assert pixel_slices(16, 8192) == 2
    assert pixel_slices(128, 8192) == 1

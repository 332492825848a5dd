"""The CUDA kernels on the card against their plain twins, and the tiled
renders against the whole-frame plain renderer. Every test here needs an
NVIDIA GPU and skips without one.

This file imports torch only, so that it runs where JAX is not installed:
  python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances:
- sorted_fwd (K3): the kernel updates T per gaussian, the twin per
  128-slot sub-block (T *= 1 - sum of contributions), so they round
  differently: rtol 1e-4 / atol 1e-5; and on a tile whose whole-tile exit
  decision fell on the other side of exit_t, the bound is exit_t itself.
  Bit-identical across two launches (each pixel composited in slot order;
  the culled pairs are those whose alpha is under the cutoff).
- splat_sep_fwd (K1): rtol 1e-5 / atol 1e-5, sums of positive terms in
  another order (its product on the tensor cores, TF32 split three ways);
  bit-identical across two launches.
- splat_sep_bwd (K2): rtol 2e-4, and atol 2e-5 times the largest
  magnitude of the output column (at least 2e-5): the moments are sums of
  signed terms that cancel, whose f32 rounding is relative to the terms,
  not to the sum (its two products on the tensor cores, TF32 split three
  ways); bit-identical across two launches.
- sorted_bwd (K4), and the sorted render's gradients: rtol 2e-3 and atol
  2e-4 times the largest magnitude of the output column (or parameter),
  the JAX suite's for its fused sorted backward (tests/test_sorted_vjp.py):
  ctg - P_i is a difference of near-equal sums divided by 1 - a >= 1e-4,
  and the kernel updates T per gaussian where the twin does per 128-slot
  sub-block.
- splat_v2_fwd (K5) and binned_fwd (K8a): rtol 1e-5 / atol 1e-5, sums of
  positive terms in another order (their products on the tensor cores,
  TF32 split three ways); both bit-identical across two launches.
- splat_v2_bwd (K6) and binned_bwd (K8b): as K2, rtol 2e-4 and atol 2e-5
  times the largest magnitude of the output column (their two products on
  the tensor cores, TF32 split three ways); bit-identical across two
  launches.
- EWA accumulation render gradients (K5/K6, K8a/K8b) against the plain
  renderer: rtol 5e-4 / atol 1e-5, as the axis footprint's.
- binned_sep_fwd (K7a) and splat_v1_fwd (K9a): rtol 1e-5 / atol 1e-5, as
  K8a and K5 (their products on the tensor cores, TF32 split three ways),
  both bit-identical across two launches; binned_sep_bwd (K7b) and
  splat_v1_bwd (K9b): as K2 (their two products on the tensor cores, TF32
  split three ways), and bit-identical across two launches; the axis
  binned render (K7a/K7b) and
  the EWA render on the tile grid (K9a/K9b) and their gradients against
  the plain renderer: rtol 5e-4 / atol 1e-5, as the other accum renders.
- stage (the per-gaussian stage's forward and backward kernels): each
  value's error against a float64 evaluation of the plain twin's formulas,
  relative to its field's largest value (forward) or its gaussian's largest
  gradient of the leaf (backward), within 4 times the f32 twin's own worst
  error plus 1e-6:
  both round in f32 in other orders (fused multiply-adds; cuBLAS's sums in
  the twin), and det = m00 m11 - m01^2 amplifies the rounding of thin
  splats, so no fixed rtol fits both thin and round ones. Bit-identical
  across two launches. A training step's leaf gradients through the
  kernels against the same step through the stage's plain composition
  under autograd: as the sorted render's gradients (the slot gather's
  atomics add in another order each run)."""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig, gaussians_from_numpy
from tpu_gaussians_torch.kernels import (
    binned, build, sorted_bwd, sorted_fwd, splat_sep, splat_v1, splat_v2,
    stage)
from tpu_gaussians_torch.ops import sorted as tsorted
from tpu_gaussians_torch.ops import splat as tsplat
from tpu_gaussians_torch.ops.common import SplatInputs, prepare_splats
from tpu_gaussians_torch.ops.dispatch import render
from tpu_gaussians_torch.ops.projection import camera_z
from tpu_gaussians_torch.utils import profiling

TILES_X, TILES_Y, CAP = 2, 2, 1024


def slot_lists(tiles_x, tiles_y, cnt, axis, op_ranges, cap=CAP, seed=0):
    """Per-tile slot lists in the kernel's input layout, as numpy: cnt[t]
    splats spread over tile t, 10-40 px wide, opacities drawn from
    op_ranges[t]; the empty slots past cnt are the dead row."""
    rng = np.random.default_rng(seed)
    n_tiles = tiles_x * tiles_y
    gd = np.zeros((n_tiles, cap, 16), np.float32)
    gd[..., 2] = gd[..., 4] = 1.0                      # dead row: op 0
    for t in range(n_tiles):
        m = cnt[t]
        x0, y0 = (t % tiles_x) * 128, (t // tiles_x) * 16
        sig = rng.uniform(10.0, 40.0, (m, 2)).astype(np.float32)
        rows = gd[t, :m]
        rows[:, 0] = x0 + rng.uniform(-20, 148, m)
        rows[:, 1] = y0 + rng.uniform(-10, 26, m)
        rows[:, 2] = 1.0 / sig[:, 0] ** 2
        rows[:, 4] = 1.0 / sig[:, 1] ** 2
        if not axis:
            rows[:, 3] = rng.uniform(-0.9, 0.9, m) * np.sqrt(
                rows[:, 2] * rows[:, 4])
        rows[:, 5] = rng.uniform(*op_ranges[t], m)
        rows[:, 6:9] = rng.uniform(0, 1, (m, 3))
        rows[:, 9] = 1.0
        rows[:, 10] = rng.uniform(1.0, 4.0, m)
    return gd.reshape(-1, 16), np.array(cnt, np.int32)


def synthetic_lists(axis, device="cpu", seed=0, cnt=(1024, 1024, 900, 300)):
    """slot_lists on the 2x2 tile grid: tile 0 is near-opaque and exits
    early at either threshold, tile 1 translucent (never exits), tile 2
    mid-way, tile 3 short."""
    gd, cnt = slot_lists(TILES_X, TILES_Y, cnt, axis, [
        (0.9, 0.99), (0.01, 0.05), (0.3, 0.8), (0.5, 0.9)], seed=seed)
    return (torch.from_numpy(gd).to(device), torch.from_numpy(cnt).to(device))


def synthetic_splats(n, height, width, seed=0, y_max=None, sigma_max=8.0):
    """Axis-footprint splat columns (px, py, ca, cb, cc, op, feats) as
    numpy f32, centres over the frame (or rows [0, y_max)), one in ten
    with zero opacity."""
    rng = np.random.default_rng(seed)
    y_hi = height + 10 if y_max is None else y_max
    sx, sy = rng.uniform(1.0, sigma_max, (2, n))
    op = rng.uniform(0.0, 1.0, n)
    op[rng.uniform(size=n) < 0.1] = 0.0
    feats = np.concatenate([rng.uniform(0, 1, (n, 3)), np.ones((n, 1)),
                            rng.uniform(1, 4, (n, 1))], axis=1)
    cols = (rng.uniform(-10, width + 10, n), rng.uniform(-10, y_hi, n),
            1.0 / sx ** 2, np.zeros(n), 1.0 / sy ** 2, op, feats)
    return tuple(np.asarray(c, np.float32) for c in cols)


def splat_inputs(cols, device="cpu"):
    """SplatInputs of synthetic columns on `device` (sigma_x/y, which only
    culling reads, are zeros)."""
    px, py, ca, cb, cc, op, feats = (torch.from_numpy(c).to(device)
                                     for c in cols)
    zero = torch.zeros_like(px)
    return SplatInputs(px, py, ca, cb, cc, zero, zero, op, feats)


def staged(cols, height, width, device):
    """(lo, cnt, gdata, rows, wp, nb) of the columns on `device`, staged by
    the accumulation path's own ops/splat.stage."""
    _, (lo, cnt, gdata, nb, wp, _, _, rows) = tsplat.stage(
        splat_inputs(cols, device), height, width)
    return lo, cnt, gdata, rows, wp, nb


def assert_moments_close(out, ref):
    """K2 rows against their reference at the tolerance stated above."""
    out, ref = np.asarray(out), np.asarray(ref)
    scale = np.maximum(np.abs(ref).max(axis=0), 1.0)
    bad = np.abs(out - ref) > 2e-4 * np.abs(ref) + 2e-5 * scale
    assert not bad.any(), (
        f"{int(bad.sum())} values off; columns {sorted(set(np.where(bad)[1]))}")


# Staged cases: a band with cnt = 0 (gaussians in the top rows only, n not
# a multiple of nb), a gaussian straddling two bands, a 1-pixel-high frame,
# many gaussians per band (R = 32), the flagship fit's shape (R = 64, Wp
# 128, 2 bands), and one band's range of about 40,000 gaussians spread over
# some 200 of K1's slices, the last one partial.
SEP_CASES = {
    "empty_bands": dict(n=700, height=256, width=96, y_max=60.0,
                        sigma_max=3.0),
    "straddle": dict(n=300, height=128, width=128),
    "one_row": dict(n=200, height=1, width=200),
    "many": dict(n=20000, height=96, width=256),
    "flagship_shape": dict(n=3000, height=128, width=128),
    "heavy": dict(n=40000, height=64, width=512, y_max=30.0),
}


def sep_case(name, device):
    kw = dict(SEP_CASES[name])
    n, height, width = kw.pop("n"), kw.pop("height"), kw.pop("width")
    cols = synthetic_splats(n, height, width, seed=3, **kw)
    if name == "straddle":   # centred on the band edge, sigma_y 6 px
        cols[1][0], cols[4][0], cols[5][0] = 64.0, 1.0 / 36.0, 0.9
    lo, cnt, gdata, rows, wp, nb = staged(cols, height, width, device)
    return lo, cnt, gdata, rows, wp, nb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("exit_t", [1e-6, 1e-3])
def test_kernel_matches_plain_twin(cuda, footprint, exit_t):
    axis = footprint == "axis"
    gdense, cnt = synthetic_lists(axis, device=cuda)
    before = sorted_fwd.launches
    acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, TILES_X, axis=axis,
                                          exit_t=exit_t)
    torch.cuda.synchronize()
    assert sorted_fwd.launches == before + 1
    ref, ref_chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, TILES_X,
                                                    axis=axis, exit_t=exit_t)
    assert chunks[:2].tolist() == [1, 2]
    assert_sorted_fwd_close(acc, chunks, ref, ref_chunks, exit_t)


def assert_sorted_fwd_close(acc, chunks, ref, ref_chunks, exit_t):
    """K3 against its twin at the tolerance stated above: rtol 1e-4 / atol
    1e-5 on tiles that exit after the same chunk, exit_t on the others."""
    same = (chunks == ref_chunks).repeat_interleave(2048).cpu().numpy()
    a, r = acc.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(a[:, same], r[:, same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a[:, ~same], r[:, ~same], atol=exit_t)


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
def test_tiled_render_matches_plain_renderer(cuda, footprint):
    rng = np.random.default_rng(1)
    n, w, h = 2000, 256, 64
    arr = dict(
        means=rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32))
    g = gaussians_from_numpy(arr, device=cuda)
    c = tcam.orbit_cameras(3, w, h, device=cuda)
    cfg = RenderConfig(width=w, height=h, mode="sorted", return_aux=True,
                       footprint=footprint)
    with torch.no_grad():
        tiled = render(g, c, cfg.replace(impl="tiled"))
        plain = render(g, c, cfg.replace(impl="torch"))
    for t, p in zip(tiled[:2], plain[:2]):
        np.testing.assert_allclose(t.cpu().numpy(), p.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEP_CASES))
def test_splat_sep_kernels_match_plain_twins(cuda, case):
    lo, cnt, gdata, rows, wp, nb = sep_case(case, cuda)
    length, slices = splat_sep.fwd_slices(lo.shape[0], rows, wp,
                                          gdata.shape[0])
    if case == "empty_bands":
        assert (cnt == 0).any() and gdata.shape[0] % nb == 0
    if case == "flagship_shape":
        assert (rows, wp, lo.shape[0]) == (64, 128, 2) and slices > 1
    if case == "heavy":
        span = int(cnt.max()) * nb
        assert span > 100 * length and span % length
    before = dict(splat_sep.launches)
    acc = splat_sep.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
    acc_again = splat_sep.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_again)      # deterministic: no atomics
    ref = splat_sep.sep_fwd_plain(lo, cnt, gdata, rows, wp, nb)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(5)
    gband = torch.randn(acc.shape, generator=gen).to(cuda)
    out = splat_sep.splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
    again = splat_sep.splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
    torch.cuda.synchronize()
    assert torch.equal(out, again)          # deterministic: no atomics
    assert splat_sep.launches == {
        "splat_sep_fwd": before["splat_sep_fwd"] + 2,
        "splat_sep_bwd": before["splat_sep_bwd"] + 2}
    ref_b = splat_sep.sep_bwd_plain(lo, cnt, gdata, gband, rows, wp, nb)
    assert_moments_close(out.cpu(), ref_b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("wp,nb", [(96, 128), (128, 32)])
def test_splat_sep_fwd_refuses_shapes_off_its_grid(cuda, wp, nb):
    """K1 takes Wp and nb in multiples of 64, its column strip and gaussian
    chunk (the staging rounds both up to multiples of 128): the wrapper
    refuses Wp 96 and nb 32 before a launch, and so does the C entry
    (cudaErrorInvalidValue, its output untouched)."""
    lo, cnt, gdata, rows, _, _ = sep_case("straddle", cuda)
    before = dict(splat_sep.launches)
    with pytest.raises(ValueError, match="multiples of 64"):
        splat_sep.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
    assert splat_sep.launches == before
    out = torch.zeros((lo.shape[0], 5, rows, wp), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        build.launch("splat_sep_fwd", (lo, cnt, gdata, out, out),
                     lo.shape[0], rows, wp, nb, gdata.shape[0])
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
def test_splat_sep_fwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["splat_sep_fwd"])
    assert build.sass_count(build.library_path("splat_sep_fwd"),
                            "splat_sep_fwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_splat_sep_bwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["splat_sep_bwd"])
    assert build.sass_count(build.library_path("splat_sep_bwd"),
                            "splat_sep_bwd_kernel", "HMMA") > 0


def sep_bwd_edge_inputs(rows, wp, n_pad, nb, lo, cnt, seed=0):
    """K2's inputs for n_pad y-sorted gaussians (sigmas 1-20 pixels,
    centres over the len(lo) bands and 10 pixels around them, one in eight
    with zero opacity), the block ranges lo/cnt as given, and an N(0,1)
    cotangent -> (lo, cnt, gdata, gband) as CPU tensors."""
    rng = np.random.default_rng(seed)
    height = len(lo) * rows
    sx, sy = rng.uniform(1.0, 20.0, (2, n_pad))
    op = rng.uniform(0.1, 0.9, n_pad)
    op[rng.uniform(size=n_pad) < 0.125] = 0.0
    feats = np.concatenate([rng.uniform(0, 1, (n_pad, 3)),
                            np.ones((n_pad, 1)),
                            rng.uniform(1, 4, (n_pad, 1))], axis=1)
    gd = np.zeros((n_pad, 16), np.float32)
    gd[:, 0] = rng.uniform(-10, wp + 10, n_pad)
    gd[:, 1] = np.sort(rng.uniform(-10, height + 10, n_pad))
    gd[:, 2], gd[:, 4] = -0.5 / sx ** 2, -0.5 / sy ** 2
    gd[:, 5] = op
    gd[:, 6:11] = feats * op[:, None]
    gband = rng.normal(size=(len(lo), 5, rows, wp)).astype(np.float32)
    return (torch.tensor(lo, dtype=torch.int32),
            torch.tensor(cnt, dtype=torch.int32), torch.from_numpy(gd),
            torch.from_numpy(gband))


# K2's edges: (rows, wp, n_pad, nb, lo, cnt, slices by the kernel's rule):
# 3 strips and an empty band (3 column slices of one strip); the
# flagship's shape (R 64, Wp 128, 2 bands over 6 blocks, overlapping: 2
# row halves x 2 column slices); 5 strips in 2 uneven column slices (3 and
# 2 strips) and an empty band; one slice (no second kernel) with a band
# whose range ends at n_pad; R 64 over 16 strips (32 slices), overlapping
# ranges.
SEP_BWD_EDGES = {
    "r32_3strips_empty_band": (32, 192, 1024, 128, [0, 2, 5], [3, 0, 3], 3),
    "r64_flagship_shape": (64, 128, 3072, 512, [0, 2], [4, 4], 4),
    "r32_uneven_column_slices": (32, 320, 12288, 512, [3, 0], [2, 0], 2),
    "r32_one_slice": (32, 128, 131072, 256, [10, 511], [1, 1], 1),
    "r64_16strips": (64, 1024, 512, 128, [0, 1, 2], [2, 2, 2], 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SEP_BWD_EDGES))
def test_splat_sep_bwd_kernel_edges(cuda, case):
    """K2 on its strip, slice and band edges against its twin, at the
    tolerance above, and bit for bit across two launches; one launch
    counted per call, whatever the slices."""
    rows, wp, n_pad, nb, lo, cnt, slices = SEP_BWD_EDGES[case]
    assert splat_sep.bwd_slices(rows, wp, n_pad) == slices
    args = [t.to(cuda) for t in sep_bwd_edge_inputs(rows, wp, n_pad, nb,
                                                    lo, cnt)]
    before = splat_sep.launches["splat_sep_bwd"]
    out = splat_sep.splat_sep_bwd(*args, rows, wp, nb)
    again = splat_sep.splat_sep_bwd(*args, rows, wp, nb)
    torch.cuda.synchronize()
    assert splat_sep.launches["splat_sep_bwd"] == before + 2
    assert torch.equal(out, again)          # deterministic: no atomics
    ref = splat_sep.sep_bwd_plain(*args, rows, wp, nb)
    assert ref.abs().amax() > 0
    assert_moments_close(out.cpu(), ref.cpu())
    untouched = torch.ones(n_pad, dtype=torch.bool)
    for l, c in zip(lo, cnt):
        untouched[l * nb:(l + c) * nb] = False
    assert not out[untouched.to(cuda)].any()   # rows of no band are zeros


@pytest.mark.cuda
@pytest.mark.parametrize("wp,nb", [(96, 128), (128, 32)])
def test_splat_sep_bwd_refuses_shapes_off_its_grid(cuda, wp, nb):
    """K2 takes Wp and nb in multiples of 64, its column strip and
    gaussian chunk (the staging rounds both up to multiples of 128): the
    wrapper refuses Wp 96 and nb 32 before a launch, and so does the C
    entry (cudaErrorInvalidValue, its output untouched)."""
    lo, cnt, gdata, rows, _, _ = sep_case("straddle", cuda)
    gband = torch.zeros((lo.shape[0], 5, rows, wp), device=cuda)
    before = dict(splat_sep.launches)
    with pytest.raises(ValueError, match="multiples of 64"):
        splat_sep.splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
    assert splat_sep.launches == before
    out = torch.zeros_like(gdata)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        build.launch("splat_sep_bwd", (lo, cnt, gdata, gband, out, out),
                     lo.shape[0], rows, wp, nb, gdata.shape[0])
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
def test_build_all_builds_every_kernel(cuda):
    build.build_all()
    for name in ("sorted_fwd", "sorted_bwd", "splat_sep_fwd",
                 "splat_sep_bwd", "splat_v2_fwd", "splat_v2_bwd",
                 "binned_fwd", "binned_bwd", "binned_sep_fwd",
                 "binned_sep_bwd", "splat_v1_fwd", "splat_v1_bwd"):
        assert name in build.KERNELS and build.library_path(name).exists()


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("exit_t", [1e-6, 1e-3])
def test_sorted_bwd_kernel_matches_plain_twin(cuda, footprint, exit_t):
    """K4 on K3's outputs: tile 0 exits after one chunk, tile 2 holds 900
    slots (a partial last chunk), tile 3 none."""
    axis = footprint == "axis"
    gdense, cnt = synthetic_lists(axis, device=cuda, cnt=(1024, 1024, 900, 0))
    acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, TILES_X, axis=axis,
                                          exit_t=exit_t)
    gen = torch.Generator().manual_seed(6)
    g8 = torch.randn(acc.shape, generator=gen).to(cuda)
    before = sorted_bwd.launches
    out = sorted_bwd.sorted_bwd(gdense, cnt, acc, g8, chunks, TILES_X, axis)
    again = sorted_bwd.sorted_bwd(gdense, cnt, acc, g8, chunks, TILES_X, axis)
    torch.cuda.synchronize()
    assert sorted_bwd.launches == before + 2
    assert torch.equal(out, again)          # deterministic: no atomics
    assert chunks.tolist()[0] == 1 and chunks.tolist()[3] == 0
    ref = sorted_bwd.sorted_bwd_plain(gdense, cnt, acc, g8, chunks, TILES_X,
                                      axis)
    assert_sorted_moments_close(out.cpu(), ref.cpu())
    rows = out.reshape(4, CAP, 16).cpu()
    assert not rows[0, 512:].any() and not rows[3].any()
    assert not rows[2, 900:].any()


def assert_sorted_moments_close(out, ref):
    """K4 rows against their twin at the tolerance stated above."""
    out, ref = np.asarray(out), np.asarray(ref)
    scale = np.abs(ref).max(axis=0)
    bad = np.abs(out - ref) > 2e-3 * np.abs(ref) + 2e-4 * scale
    assert not bad.any(), (
        f"{int(bad.sum())} values off; columns {sorted(set(np.where(bad)[1]))}")


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
def test_sorted_render_grads_match_plain_renderer(cuda, footprint):
    """render(mode="sorted") values and gradients: tiled (K3/K4 through the
    autograd Function) against the plain renderer, on the card."""
    rng = np.random.default_rng(3)
    n, w, h = 2000, 256, 64
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(
        np.float32)).to(cuda)
    c = tcam.orbit_cameras(3, w, h, device=cuda)[1]
    cfg = RenderConfig(width=w, height=h, mode="sorted", return_aux=True,
                       footprint=footprint)
    outs = {}
    for impl in ("tiled", "torch"):
        g = gaussians_from_numpy(arr, device=cuda)
        leaves = [t.requires_grad_(True) for t in (
            g.means, g.scales, g.opacities, g.colors, g.quats)]
        img, alpha, _ = render(g, c, cfg.replace(impl=impl))
        ((img - target).abs().mean() + alpha.mean()).backward()
        outs[impl] = [img.detach(), alpha.detach()] + [
            t.grad for t in leaves if t.grad is not None]
    assert len(outs["tiled"]) == len(outs["torch"]) == (
        7 if footprint == "ewa" else 6)
    for a, b in zip(outs["tiled"], outs["torch"]):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-3, atol=2e-4 * scale)


# K5 cases: n not a multiple of nb (below SORT_MM_MAX), a 1-pixel-high
# frame, and y-sorted gaussians over many bands.
V2_CASES = {
    "ragged_n": dict(n=1000, height=48, width=96),
    "one_row": dict(n=300, height=1, width=700),
    "many": dict(n=8000, height=128, width=256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_splat_v2_kernel_matches_plain_twin(cuda, case):
    kw = V2_CASES[case]
    n, height, width = kw["n"], kw["height"], kw["width"]
    cols = list(synthetic_splats(n, height, width, seed=4))
    rng = np.random.default_rng(5)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    lo, cnt, gdata, nb, hw_pad = tsplat._v2_prep(
        tsplat.y_sorted(splat_inputs(cols, cuda)), height, width)
    if case == "ragged_n":
        assert n % nb != 0
    before = splat_v2.launches["splat_v2_fwd"]
    acc = splat_v2.splat_v2_fwd(lo, cnt, gdata, hw_pad, width, nb)
    again = splat_v2.splat_v2_fwd(lo, cnt, gdata, hw_pad, width, nb)
    torch.cuda.synchronize()
    assert splat_v2.launches["splat_v2_fwd"] == before + 2
    assert torch.equal(acc, again)          # deterministic: no atomics
    ref = splat_v2.v2_fwd_plain(lo, cnt, gdata, hw_pad, width, nb)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_splat_v2_bwd_kernel_matches_plain_twin(cuda, case):
    """K6 on a seeded cotangent, zero beyond the frame and in rows 5-7."""
    kw = V2_CASES[case]
    n, height, width = kw["n"], kw["height"], kw["width"]
    cols = list(synthetic_splats(n, height, width, seed=4))
    rng = np.random.default_rng(5)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    lo, cnt, gdata, nb, hw_pad = tsplat._v2_prep(
        tsplat.y_sorted(splat_inputs(cols, cuda)), height, width)
    g8 = torch.zeros((8, hw_pad), device=cuda)
    g8[:5, :height * width] = torch.randn(
        (5, height * width), generator=torch.Generator().manual_seed(7)).to(
            cuda)
    before = splat_v2.launches["splat_v2_bwd"]
    out = splat_v2.splat_v2_bwd(lo, cnt, gdata, g8, hw_pad, width, nb)
    again = splat_v2.splat_v2_bwd(lo, cnt, gdata, g8, hw_pad, width, nb)
    torch.cuda.synchronize()
    assert splat_v2.launches["splat_v2_bwd"] == before + 2
    assert torch.equal(out, again)          # deterministic: no atomics
    ref = splat_v2.v2_bwd_plain(lo, cnt, gdata, g8, hw_pad, width, nb)
    assert_moments_close(out.cpu(), ref.cpu())


def v2_bwd_edge_inputs(width, height, nb, n_blocks, ranges, n_real,
                       seed=0):
    """K6's inputs built directly, not through the staging: n_real general
    conics over the frame (and 10 px past it) in K5's pre-scaled form (a'
    = -a/2, b' = -b, c' = -c/2, featsop = feats * op), a tenth at zero
    opacity, then padding rows (op 0, identity conic) up to n_blocks * nb;
    band i's block range ranges[i] = (lo, cnt); an N(0,1) cotangent on every
    row and every padded pixel, so that the kernel and its twin see the same
    work beyond the frame."""
    rng = np.random.default_rng(seed)
    hw_pad = -(-width * height // splat_v2.TP2) * splat_v2.TP2
    assert len(ranges) == hw_pad // splat_v2.TP2
    n = n_blocks * nb
    gd = np.zeros((n, 16), np.float32)
    gd[:, 2] = gd[:, 4] = -0.5
    sx, sy = rng.uniform(1.0, 8.0, (2, n_real))
    a, c = 1.0 / sx ** 2, 1.0 / sy ** 2
    b = rng.uniform(-0.9, 0.9, n_real) * np.sqrt(a * c)
    op = rng.uniform(0.0, 1.0, n_real) * (rng.uniform(size=n_real) >= 0.1)
    gd[:n_real, 0] = rng.uniform(-10, width + 10, n_real)
    gd[:n_real, 1] = rng.uniform(-10, height + 10, n_real)
    gd[:n_real, 2], gd[:n_real, 3], gd[:n_real, 4] = -0.5 * a, -b, -0.5 * c
    gd[:n_real, 5] = op
    gd[:n_real, 6:14] = rng.normal(size=(n_real, 8)) * op[:, None]
    lo, cnt = (np.array(v, np.int32) for v in zip(*ranges))
    g8 = rng.normal(size=(8, hw_pad)).astype(np.float32)
    return (torch.from_numpy(lo), torch.from_numpy(cnt), torch.from_numpy(gd),
            torch.from_numpy(g8), hw_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 4, 8, 16])
def test_splat_v2_bwd_kernel_edges(cuda, slices):
    """K6 against its twin at each slice count its rule picks (the n_pad
    that gives it on this card), bit-identical across two launches, on a
    width of 200 (bands end mid-row, row segments of no multiple of 8
    pixels, the last band partly past the frame) with nb = 256 (two CUDA
    blocks an nb-block): band 0's range ends in the nb-block that holds the
    padding rows, band 2's is empty, and the blocks that no range holds
    give zero rows."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    blocks128 = 24 if slices == 16 else -(-4 * sms // slices)
    nb = 256
    n_blocks = -(-blocks128 // 2)
    n_real = n_blocks * nb - 100
    assert splat_v2.bwd_slices(n_blocks * nb, cuda) == slices
    ranges = [(n_blocks - 2, 2), (1, 3), (0, 0), (0, 1), (3, 2)]
    lo, cnt, gdata, g8, hw_pad = v2_bwd_edge_inputs(
        200, 41, nb, n_blocks, ranges, n_real, seed=slices)
    args = (lo.to(cuda), cnt.to(cuda), gdata.to(cuda), g8.to(cuda), hw_pad,
            200, nb)
    before = splat_v2.launches["splat_v2_bwd"]
    out = splat_v2.splat_v2_bwd(*args)
    again = splat_v2.splat_v2_bwd(*args)
    torch.cuda.synchronize()
    assert splat_v2.launches["splat_v2_bwd"] == before + 2
    assert torch.equal(out, again)          # deterministic: no atomics
    ref = splat_v2.v2_bwd_plain(*args)
    assert_moments_close(out.cpu(), ref.cpu())
    rows = out.reshape(n_blocks, nb, 16).cpu()
    assert not rows[:, :, [5, 14, 15]].any()
    held = {j for l, c in ranges for j in range(l, l + c)}
    for j in range(n_blocks):
        assert rows[j].any() == (j in held)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 4, 8, 12, 16])
def test_splat_v2_fwd_kernel_edges(cuda, slices):
    """K5 against its twin at slice counts its rule picks (the band count
    and n_pad that give it on this card: 12 is 16 trimmed to what 24
    chunks fill, as on the flagship), bit-identical across two launches,
    on a width of 200 (warps straddle rows, bands end mid-row, the last
    band partly past the frame) with nb = 256: band 0's range ends in the
    nb-block that holds the padding rows, band 2's is empty (its columns
    exactly zero), band 4's is the whole of gdata, and the rest are seeded
    ranges of 1 to 6 nb-blocks, some shorter than the slice count in
    128-row chunks."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_bands = 5 if slices >= 12 else -(-6 * sms // (4 * slices))
    height = n_bands * splat_v2.TP2 // 200
    nb, n_blocks = 256, 12 if slices == 12 else 8
    rng = np.random.default_rng(slices)
    ranges = [(n_blocks - 2, 2), (1, 3), (0, 0), (0, 1), (0, n_blocks)]
    for _ in range(n_bands - 5):
        c = int(rng.integers(1, 7))
        ranges.append((int(rng.integers(0, n_blocks - c + 1)), c))
    lo, cnt, gdata, _, hw_pad = v2_bwd_edge_inputs(
        200, height, nb, n_blocks, ranges, n_blocks * nb - 100, seed=slices)
    assert hw_pad == n_bands * splat_v2.TP2
    assert splat_v2.fwd_slices(n_bands, n_blocks * nb, gdata.to(
        cuda).device) == slices
    args = (lo.to(cuda), cnt.to(cuda), gdata.to(cuda), hw_pad, 200, nb)
    before = splat_v2.launches["splat_v2_fwd"]
    acc = splat_v2.splat_v2_fwd(*args)
    again = splat_v2.splat_v2_fwd(*args)
    torch.cuda.synchronize()
    assert splat_v2.launches["splat_v2_fwd"] == before + 2
    assert torch.equal(acc, again)          # deterministic: no atomics
    ref = splat_v2.v2_fwd_plain(*args)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not acc[:, 2 * splat_v2.TP2:3 * splat_v2.TP2].any()
    assert acc[:, :200 * height].abs().amax(dim=1)[:5].gt(0).all()


@pytest.mark.cuda
def test_splat_v2_fwd_kernel_skips_dead_rows(cuda):
    """K5 against its twin, bit-identical across two launches, where most
    rows are dead capacity as in a fit (op 0, all at one screen point, so
    the y-sort puts them side by side inside the band ranges): whole
    8-row steps of zero featsop, which the kernel skips, lie inside the
    ranges."""
    n, height, width = 3000, 128, 128
    cols = list(synthetic_splats(n, height, width, seed=6))
    rng = np.random.default_rng(7)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    cols[0][800:], cols[1][800:], cols[5][800:] = 64.0, 64.0, 0.0
    lo, cnt, gdata, nb, hw_pad = tsplat._v2_prep(
        tsplat.y_sorted(splat_inputs(cols, cuda)), height, width)
    dead = ~gdata[:, 6:14].reshape(-1, 8, 8).any(dim=(1, 2))
    held = torch.zeros_like(dead)
    for l, c in zip(lo.tolist(), cnt.tolist()):
        held[l * nb // 8:(l + c) * nb // 8] = True
    assert int((dead & held).sum()) > 100
    args = (lo, cnt, gdata, hw_pad, width, nb)
    acc = splat_v2.splat_v2_fwd(*args)
    again = splat_v2.splat_v2_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(acc, again)          # deterministic: no atomics
    ref = splat_v2.v2_fwd_plain(*args)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_splat_v2_fwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["splat_v2_fwd"])
    assert build.sass_count(build.library_path("splat_v2_fwd"),
                            "splat_v2_fwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_splat_v2_bwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["splat_v2_bwd"])
    assert build.sass_count(build.library_path("splat_v2_bwd"),
                            "splat_v2_bwd_kernel", "HMMA") > 0


def _scene_grid_counts():
    """128 tile counts at cap 8192 (the 100k 512x512 scene's grid, where
    K8a's slices are 1024 slots): seeded, with tile 0 full, tile 1 empty,
    tile 2 at 3000 (not a multiple of the slice), 3 and 4 either side of a
    slice edge."""
    cnt = np.random.default_rng(4).integers(0, 8193, 128)
    cnt[:5] = (8192, 0, 3000, 1024, 1025)
    return tuple(int(c) for c in cnt)


# (tiles_x, tiles_y, cap, cnt) of K8a/K8b's card cases.
BINNED_CASES = {
    "full_partial_empty_short": (TILES_X, TILES_Y, CAP, (1024, 600, 0, 300)),
    "chunk_edges": (TILES_X, TILES_Y, CAP, (1, 512, 513, 1024)),
    "cap8192_scene_grid": (4, 32, 8192, _scene_grid_counts()),
    "flagship_shape": (1, 8, 8192, (886, 0, 129, 1100, 8192, 1, 640, 300)),
    # 16 tiles at cap 8192: K8b in 2 pixel slices (blocks of 64 slots),
    # counts on either side of its 32-slot warp and 64-slot block edges.
    "pixel_halves": (2, 8, 8192, (31, 32, 33, 63, 64, 65, 127, 8192, 0, 1,
                                  4000, 2049, 96, 7777, 160, 300)),
}
# K8b's pixel slices at each case's shapes (csrc/binned_bwd.cu).
BWD_PIXEL_SLICES = {"full_partial_empty_short": 4, "chunk_edges": 4,
                    "cap8192_scene_grid": 1, "flagship_shape": 4,
                    "pixel_halves": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BINNED_CASES))
def test_binned_kernels_match_plain_twins(cuda, case):
    """K8a and K8b on lists with a tile at cap, one empty, and counts on
    either side of a 512-slot chunk edge; at cap 8192 on the 100k scene's
    128 tiles (K8a's slices of 1024, a count that is not a multiple of
    it) and on the flagship's 8 tiles (slices of 128); K8b with each of its
    pixel slicings (4, 1, 4, and 2 on 16 tiles, counts either side of its
    warp and block edges). Both bit-identical across two launches, an
    empty tile's sums exactly zero, K8b's rows past each processed chunk
    zero."""
    tiles_x, tiles_y, cap, cnt = BINNED_CASES[case]
    n_tiles = tiles_x * tiles_y
    if cap == CAP:       # synthetic_lists' own grid and opacities
        gdense, cnt_t = synthetic_lists(False, device=cuda, cnt=cnt)
    else:
        gd, cnt_np = slot_lists(tiles_x, tiles_y, cnt, False,
                                [(0.2, 0.9)] * n_tiles, cap=cap)
        gdense = torch.from_numpy(gd).to(cuda)
        cnt_t = torch.from_numpy(cnt_np).to(cuda)
    length, slices = binned.fwd_slices(n_tiles, cap)
    if case == "cap8192_scene_grid":
        assert (length, slices) == (1024, 8) and cnt[2] % length
    if case == "flagship_shape":
        assert (length, slices) == (128, 64)
    assert binned.bwd_pixel_slices(n_tiles, cap) == BWD_PIXEL_SLICES[case]
    before = dict(binned.launches)
    acc = binned.binned_fwd(gdense, cnt_t, tiles_x)
    acc_again = binned.binned_fwd(gdense, cnt_t, tiles_x)
    g8 = torch.randn(acc.shape, generator=torch.Generator().manual_seed(8)
                     ).to(cuda)
    out = binned.binned_bwd(gdense, cnt_t, g8, tiles_x)
    again = binned.binned_bwd(gdense, cnt_t, g8, tiles_x)
    torch.cuda.synchronize()
    assert binned.launches == {**before,
                               "binned_fwd": before["binned_fwd"] + 2,
                               "binned_bwd": before["binned_bwd"] + 2}
    assert torch.equal(acc, acc_again)      # deterministic: no atomics
    assert torch.equal(out, again)
    ref = binned.binned_fwd_plain(gdense, cnt_t, tiles_x)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    ref_b = binned.binned_bwd_plain(gdense, cnt_t, g8, tiles_x)
    assert_moments_close(out.cpu(), ref_b.cpu())
    rows = out.reshape(n_tiles, cap, 16).cpu()
    sums = acc.reshape(8, n_tiles, 2048).cpu()
    for t, c in enumerate(cnt):              # chunks at or past cnt: zero
        assert not rows[t, -(-c // 512) * 512:].any()
        if c == 0:
            assert not sums[:, t].any()


@pytest.mark.cuda
def test_binned_fwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["binned_fwd"])
    assert build.sass_count(build.library_path("binned_fwd"),
                            "binned_fwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_binned_bwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["binned_bwd"])
    assert build.sass_count(build.library_path("binned_bwd"),
                            "binned_bwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_binned_bwd_rejects_misaligned_g8(cuda):
    # K8b stages g8 with 16-byte cp.async: a contiguous view 4 bytes into
    # its storage is refused before the launch, not left to fault.
    gdense, cnt = synthetic_lists(False, device=cuda)
    n = 8 * TILES_X * TILES_Y * 2048
    buf = torch.zeros(n + 1, device=cuda)
    shifted = buf[1:].view(8, n // 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        binned.binned_bwd(gdense, cnt, shifted, TILES_X)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("binned_mode", ["off", "on"])
def test_ewa_accum_render_grads_match_plain_renderer(cuda, binned_mode):
    """render(mode="accum", footprint="ewa") values and gradients: tiled
    (K5/K6, or K8a/K8b under accum_binned "on") against the plain renderer,
    on the card, on a frame of ragged tiles and bands."""
    rng = np.random.default_rng(4)
    n, w, h = 3000, 200, 72
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.06, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(
        np.float32)).to(cuda)
    c = tcam.orbit_cameras(3, w, h, device=cuda)[1]
    cfg = RenderConfig(width=w, height=h, mode="accum", footprint="ewa",
                       return_aux=True, accum_binned=binned_mode)
    outs = {}
    for impl in ("tiled", "torch"):
        g = gaussians_from_numpy(arr, device=cuda)
        leaves = [t.requires_grad_(True) for t in (
            g.means, g.scales, g.opacities, g.colors, g.quats)]
        img, alpha, _ = render(g, c, cfg.replace(impl=impl))
        (img - target).abs().mean().backward()
        outs[impl] = [img.detach(), alpha.detach()] + [t.grad for t in leaves]
    for a, b in zip(outs["tiled"], outs["torch"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=5e-4, atol=1e-5)


@pytest.mark.cuda
def test_accum_render_grads_match_plain_renderer(cuda):
    """render(mode="accum") values and gradients: tiled (K1/K2 through the
    autograd Function) against the plain renderer, on the card."""
    rng = np.random.default_rng(2)
    n, w, h = 3000, 160, 96
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(
        np.float32)).to(cuda)
    c = tcam.orbit_cameras(3, w, h, device=cuda)[1]
    cfg = RenderConfig(width=w, height=h, mode="accum", return_aux=True)
    outs = {}
    for impl in ("tiled", "torch"):
        g = gaussians_from_numpy(arr, device=cuda)
        leaves = [t.requires_grad_(True) for t in (g.means, g.scales,
                                                   g.opacities, g.colors)]
        img, alpha, depth = render(g, c, cfg.replace(impl=impl))
        (img - target).abs().mean().backward()
        outs[impl] = [img.detach(), alpha.detach()] + [t.grad for t in leaves]
    for a, b in zip(outs["tiled"], outs["torch"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=5e-4, atol=1e-5)


# (tiles_x, tiles_y, cap, cnt) of K7a/K7b's card cases.
BINNED_SEP_CASES = {
    "full_partial_empty_short": (TILES_X, TILES_Y, CAP, (1024, 600, 0, 300)),
    "chunk_edges": (TILES_X, TILES_Y, CAP, (1, 512, 513, 1024)),
    "cap8192_scene_grid": (4, 32, 8192, _scene_grid_counts()),
    "flagship_shape": (1, 8, 3072, (867, 0, 129, 64, 3072, 1, 640, 65)),
    # 32 tiles at cap 8192: K7b in blocks of 128 slots, one column slice;
    # counts on either side of its 16-slot warp, 128-slot block and 512-slot
    # (a 100k block's) edges, each chunk's dead slots computed.
    "block_edges": (4, 8, 8192, (15, 16, 17, 127, 128, 129, 255, 256, 257,
                                 511, 512, 513, 8192, 0, 1, 4000, 1023,
                                 1024, 1025, 2047, 2048, 2049, 100, 300, 600,
                                 5000, 7000, 8191, 64, 65, 3, 7777)),
}
# K7a's slices at each case's shapes (csrc/binned_sep_fwd.cu:slice_len).
SEP_FWD_SLICES = {"full_partial_empty_short": (128, 8),
                  "chunk_edges": (128, 8), "cap8192_scene_grid": (1024, 8),
                  "flagship_shape": (128, 24), "block_edges": (256, 32)}
# K7b's column slices at each case's shapes (csrc/binned_sep_bwd.cu).
SEP_BWD_COL_SLICES = {"full_partial_empty_short": 2, "chunk_edges": 2,
                      "cap8192_scene_grid": 1, "flagship_shape": 2,
                      "block_edges": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BINNED_SEP_CASES))
def test_binned_sep_kernels_match_plain_twins(cuda, case):
    """K7a and K7b on axis lists (conic b = 0) with a tile at cap, one
    empty, and counts on either side of a 512-slot chunk edge; at cap 8192
    on the 100k scene's 128 tiles (K7a's slices of 1024, a count that is
    not a multiple of it) and on the flagship's 8 tiles at cap 3072
    (slices of 128, counts on either side of K7a's 64-slot chunk); K7b
    with each of its column slicings (2, 2, 1, 2, and 1 on 32 tiles,
    counts either side of its warp and block edges). Both bit-identical
    across two launches, an empty tile's sums exactly zero, K7b's rows
    past each processed chunk zero."""
    tiles_x, tiles_y, cap, cnt = BINNED_SEP_CASES[case]
    n_tiles = tiles_x * tiles_y
    if cap == CAP:       # synthetic_lists' own grid and opacities
        gdense, cnt_t = synthetic_lists(True, device=cuda, cnt=cnt)
    else:
        gd, cnt_np = slot_lists(tiles_x, tiles_y, cnt, True,
                                [(0.2, 0.9)] * n_tiles, cap=cap)
        gdense = torch.from_numpy(gd).to(cuda)
        cnt_t = torch.from_numpy(cnt_np).to(cuda)
    assert binned.fwd_slices(n_tiles, cap, "binned_sep_fwd") == \
        SEP_FWD_SLICES[case]
    assert binned.bwd_col_slices(n_tiles, cap) == SEP_BWD_COL_SLICES[case]
    before = dict(binned.launches)
    acc = binned.binned_sep_fwd(gdense, cnt_t, tiles_x)
    acc_again = binned.binned_sep_fwd(gdense, cnt_t, tiles_x)
    g8 = torch.randn(acc.shape, generator=torch.Generator().manual_seed(9)
                     ).to(cuda)
    out = binned.binned_sep_bwd(gdense, cnt_t, g8, tiles_x)
    again = binned.binned_sep_bwd(gdense, cnt_t, g8, tiles_x)
    torch.cuda.synchronize()
    assert binned.launches == {
        **before, "binned_sep_fwd": before["binned_sep_fwd"] + 2,
        "binned_sep_bwd": before["binned_sep_bwd"] + 2}
    assert torch.equal(acc, acc_again)      # deterministic: no atomics
    assert torch.equal(out, again)
    ref = binned.binned_sep_fwd_plain(gdense, cnt_t, tiles_x)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    ref_b = binned.binned_sep_bwd_plain(gdense, cnt_t, g8, tiles_x)
    assert_moments_close(out.cpu(), ref_b.cpu())
    rows = out.reshape(n_tiles, cap, 16).cpu()
    sums = acc.reshape(8, n_tiles, 2048).cpu()
    for t, c in enumerate(cnt):              # chunks at or past cnt: zero
        assert not rows[t, -(-c // 512) * 512:].any()
        if c == 0:
            assert not sums[:, t].any()


@pytest.mark.cuda
def test_binned_sep_fwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["binned_sep_fwd"])
    assert build.sass_count(build.library_path("binned_sep_fwd"),
                            "binned_sep_fwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_binned_sep_bwd_kernel_runs_on_tensor_cores(cuda):
    build.build_all(["binned_sep_bwd"])
    assert build.sass_count(build.library_path("binned_sep_bwd"),
                            "binned_sep_bwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_binned_sep_bwd_rejects_misaligned_g8(cuda):
    # K7b stages g8 with 16-byte loads: a contiguous view 4 bytes into its
    # storage is refused before the launch, not left to fault.
    gdense, cnt = synthetic_lists(True, device=cuda)
    n = 8 * TILES_X * TILES_Y * 2048
    buf = torch.zeros(n + 1, device=cuda)
    shifted = buf[1:].view(8, n // 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(binned.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        binned.binned_sep_bwd(gdense, cnt, shifted, TILES_X)
    torch.cuda.synchronize()
    assert binned.launches == before


@pytest.mark.cuda
def test_binned_sep_fwd_rejects_misaligned_gdense(cuda):
    # K7a stages gdense with 16-byte cp.async: a contiguous view 4 bytes
    # into its storage is refused before the launch, not left to fault.
    gdense, cnt = synthetic_lists(True, device=cuda)
    buf = torch.zeros(gdense.numel() + 1, device=cuda)
    shifted = buf[1:].view(gdense.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        binned.binned_sep_fwd(shifted, cnt, TILES_X)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_splat_v1_kernels_match_plain_twins(cuda, case):
    """K9a, and K9b on a seeded cotangent (zero beyond the frame and in
    rows 5-7), on the tile grid's staging of V2_CASES' general conics."""
    kw = V2_CASES[case]
    n, height, width = kw["n"], kw["height"], kw["width"]
    cols = list(synthetic_splats(n, height, width, seed=4))
    rng = np.random.default_rng(5)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    mask, gdata, nb, tp, hw_pad = tsplat._v1_prep(
        tsplat.y_sorted(splat_inputs(cols, cuda)), height, width)
    g8 = torch.zeros((8, hw_pad), device=cuda)
    g8[:5, :height * width] = torch.randn(
        (5, height * width), generator=torch.Generator().manual_seed(7)).to(
            cuda)
    before = dict(splat_v1.launches)
    acc = splat_v1.splat_v1_fwd(mask, gdata, hw_pad, width, nb, tp)
    out = splat_v1.splat_v1_bwd(mask, gdata, g8, hw_pad, width, nb, tp)
    again = splat_v1.splat_v1_bwd(mask, gdata, g8, hw_pad, width, nb, tp)
    torch.cuda.synchronize()
    assert splat_v1.launches == {
        "splat_v1_fwd": before["splat_v1_fwd"] + 1,
        "splat_v1_bwd": before["splat_v1_bwd"] + 2}
    assert torch.equal(out, again)          # deterministic: no atomics
    ref = splat_v1.v1_fwd_plain(mask, gdata, hw_pad, width, nb, tp)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    ref_b = splat_v1.v1_bwd_plain(mask, gdata, g8, hw_pad, width, nb, tp)
    assert_moments_close(out.cpu(), ref_b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["axis_binned", "ewa_mixed", "ewa_v1"])
def test_accum_render_grads_on_new_routes_match_plain_renderer(
        cuda, monkeypatch, route):
    """render(mode="accum") values and gradients through the axis
    footprint's binned K7a/K7b (accum_binned "on"), and the EWA footprint
    with the forward on K5 and the backward on K9b, or both on K9a/K9b
    (the route thresholds lowered to 0), against the plain renderer."""
    if route == "ewa_mixed":
        monkeypatch.setattr(tsplat, "V2_MAX_N_PAD_BWD", 0)
    elif route == "ewa_v1":
        monkeypatch.setattr(tsplat, "V2_MAX_N_PAD_FWD", 0)
        monkeypatch.setattr(tsplat, "V2_MAX_N_PAD_BWD", 0)
    rng = np.random.default_rng(6)
    n, w, h = 3000, 200, 72
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.06, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    if route != "axis_binned":
        arr["quats"] = rng.normal(size=(n, 4)).astype(np.float32)
    target = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(
        np.float32)).to(cuda)
    c = tcam.orbit_cameras(3, w, h, device=cuda)[1]
    cfg = RenderConfig(width=w, height=h, mode="accum", return_aux=True,
                       footprint="axis" if route == "axis_binned" else "ewa",
                       accum_binned="on" if route == "axis_binned" else "off")
    before = {**binned.launches, **splat_v1.launches}
    outs = {}
    for impl in ("tiled", "torch"):
        g = gaussians_from_numpy(arr, device=cuda)
        leaves = [t.requires_grad_(True) for t in (
            g.means, g.scales, g.opacities, g.colors)]
        img, alpha, _ = render(g, c, cfg.replace(impl=impl))
        (img - target).abs().mean().backward()
        outs[impl] = [img.detach(), alpha.detach()] + [t.grad for t in leaves]
    after = {**binned.launches, **splat_v1.launches}
    grew = sorted(k for k in after if after[k] > before[k])
    assert grew == {"axis_binned": ["binned_sep_bwd", "binned_sep_fwd"],
                    "ewa_mixed": ["splat_v1_bwd"],
                    "ewa_v1": ["splat_v1_bwd", "splat_v1_fwd"]}[route]
    for a, b in zip(outs["tiled"], outs["torch"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=5e-4, atol=1e-5)


def v1_edge_inputs(width, height, tp, nb, n_blocks, empty=(), seed=0):
    """Tile-grid inputs built directly, not through the staging: general
    conics over the frame (and 10 px past it), a tenth at zero opacity, 8
    feature columns; a random mask with the blocks in `empty` active in no
    tile; an N(0,1) cotangent on every row and every padded pixel, so that
    the kernel and its twin see the same work beyond the frame."""
    rng = np.random.default_rng(seed)
    hw_pad = -(-width * height // tp) * tp
    n_tiles, n = hw_pad // tp, n_blocks * nb
    sx, sy = rng.uniform(1.0, 8.0, (2, n))
    gd = np.zeros((n, 16), np.float32)
    gd[:, 0] = rng.uniform(-10, width + 10, n)
    gd[:, 1] = rng.uniform(-10, height + 10, n)
    gd[:, 2], gd[:, 4] = 1.0 / sx ** 2, 1.0 / sy ** 2
    gd[:, 3] = rng.uniform(-0.9, 0.9, n) * np.sqrt(gd[:, 2] * gd[:, 4])
    gd[:, 5] = rng.uniform(0.0, 1.0, n) * (rng.uniform(size=n) >= 0.1)
    gd[:, 6:14] = rng.normal(size=(n, 8))
    mask = (rng.uniform(size=(n_tiles, n_blocks)) < 0.7).astype(np.uint8)
    mask[:, list(empty)] = 0
    g8 = rng.normal(size=(8, hw_pad)).astype(np.float32)
    return (torch.from_numpy(mask), torch.from_numpy(gd),
            torch.from_numpy(g8), hw_pad)


# K9b's edges: rows that tp does not divide (partial row segments, the last
# tile partly in the frame), rows whose length is no multiple of 8 (the
# pixel groups of a segment end part-way), tiles shorter than a row, and
# blocks that no tile's mask holds (their rows must be zero).
V1_EDGE_CASES = {
    "partial_rows": dict(width=200, height=40, tp=2048, nb=128, n_blocks=3),
    "unaligned_rows": dict(width=100, height=50, tp=384, nb=256, n_blocks=2),
    "short_tiles": dict(width=333, height=7, tp=128, nb=128, n_blocks=2),
    "empty_blocks": dict(width=96, height=64, tp=1024, nb=128, n_blocks=5,
                         empty=(1, 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V1_EDGE_CASES))
def test_splat_v1_bwd_kernel_edges(cuda, case):
    kw = dict(V1_EDGE_CASES[case])
    width, tp, nb = kw["width"], kw["tp"], kw["nb"]
    mask, gdata, g8, hw_pad = (x if isinstance(x, int) else x.to(cuda)
                               for x in v1_edge_inputs(**kw, seed=8))
    args = (mask, gdata, g8, hw_pad, width, nb, tp)
    out = splat_v1.splat_v1_bwd(*args)
    again = splat_v1.splat_v1_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)          # deterministic: no atomics
    ref = splat_v1.v1_bwd_plain(*args)
    assert_moments_close(out.cpu(), ref.cpu())
    rows = out.reshape(-1, nb, 16).cpu()
    assert not rows[:, :, 14:].any()
    for j in kw.get("empty", ()):
        assert not rows[j].any()
    active = [j for j in range(rows.shape[0]) if j not in kw.get("empty", ())]
    assert rows[active].any()


# K9a's: V1_EDGE_CASES, and a width that is no multiple of 16 at the
# largest tile (warps whose 128 pixels straddle frame rows; a 16-pixel mma
# tile split between two rows).
V1_FWD_EDGE_CASES = {
    **V1_EDGE_CASES,
    "width_250": dict(width=250, height=20, tp=2048, nb=256, n_blocks=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(V1_FWD_EDGE_CASES))
def test_splat_v1_fwd_kernel_edges(cuda, case):
    """K9a against its twin, bit-identical across two launches, exact zeros
    on a tile whose mask row is empty, and tensor-core instructions in its
    SASS."""
    kw = dict(V1_FWD_EDGE_CASES[case])
    width, tp, nb = kw["width"], kw["tp"], kw["nb"]
    mask, gdata, _, hw_pad = v1_edge_inputs(**kw, seed=9)
    empty_tile = mask.shape[0] // 2
    mask[empty_tile] = 0
    mask, gdata = mask.to(cuda), gdata.to(cuda)
    args = (mask, gdata, hw_pad, width, nb, tp)
    acc = splat_v1.splat_v1_fwd(*args)
    again = splat_v1.splat_v1_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(acc, again)          # deterministic: no atomics
    ref = splat_v1.v1_fwd_plain(*args)
    np.testing.assert_allclose(acc.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for i in range(mask.shape[0]):
        if not mask[i].any():
            assert not acc[:, i * tp:(i + 1) * tp].any()
    assert build.sass_count(build.library_path("splat_v1_fwd"),
                            "splat_v1_fwd_kernel", "HMMA") > 0


@pytest.mark.cuda
def test_splat_v1_bwd_rejects_misaligned_g8(cuda):
    # K9b stages g8 with 16-byte cp.async: a contiguous view 4 bytes into
    # its storage is refused before the launch, not left to fault.
    mask, gdata, g8, hw_pad = (x if isinstance(x, int) else x.to(cuda)
                               for x in v1_edge_inputs(96, 64, 1024, 128, 2))
    buf = torch.zeros(g8.numel() + 1, device=cuda)
    shifted = buf[1:].view(g8.shape)
    shifted.copy_(g8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        splat_v1.splat_v1_bwd(mask, gdata, shifted, hw_pad, 96, 128, 1024)
    torch.cuda.synchronize()


def launched_blocks(fn, kernel, tries=3):
    """Thread blocks of each launch of the kernel whose name holds `kernel`
    that fn() makes: the grid of its kernel events in a torch.profiler
    trace of three calls of fn, which must agree. The profiler now and then
    keeps no launch of the kernel in a window on an H100 (an event near the
    window's ends can fall outside it by the profiler's clock): such a
    window is traced again with 2 s of wait at both ends, at most `tries`
    windows in all, with a warning."""
    import json
    import tempfile
    import time
    import warnings
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        pad = 0.0 if attempt == 1 else 2.0
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad)
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        grids = {tuple(e["args"]["grid"]) for e in events
                 if e.get("cat") == "kernel" and kernel in e.get("name", "")}
        if grids or attempt == tries:
            break
        warnings.warn(
            f"profiler window {attempt} kept no launch of {kernel} "
            f"({sum(e.get('cat') == 'kernel' for e in events)} kernel and "
            f"{sum(e.get('cat') == 'cuda_runtime' for e in events)} runtime "
            "events); tracing again")
    assert len(grids) == 1
    return int(np.prod(grids.pop()))


# K4's edges: one tile (one cluster); an odd tile count; tiles with no slot;
# and chunks_done below ceil(cnt / 512) (rows past the last chunk zero).
SORTED_EDGE_CASES = {
    "one_tile": dict(tiles_x=1, tiles_y=1, cnt=(1000,), chunks=None),
    "odd_tiles": dict(tiles_x=3, tiles_y=1, cnt=(700, 0, 1024), chunks=None),
    "empty": dict(tiles_x=1, tiles_y=2, cnt=(0, 0), chunks=None),
    "chunks_cut": dict(tiles_x=2, tiles_y=2, cnt=(1024, 1000, 600, 513),
                       chunks=(1, 0, 1, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("case", sorted(SORTED_EDGE_CASES))
def test_sorted_bwd_kernel_edges(cuda, case, footprint):
    kw = SORTED_EDGE_CASES[case]
    axis = footprint == "axis"
    n_tiles = kw["tiles_x"] * kw["tiles_y"]
    gdense, cnt = (torch.from_numpy(t).to(cuda) for t in slot_lists(
        kw["tiles_x"], kw["tiles_y"], kw["cnt"], axis,
        [(0.01, 0.2), (0.5, 0.95)] * n_tiles, seed=9))
    acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, kw["tiles_x"],
                                          axis=axis, exit_t=1e-6)
    if kw["chunks"] is not None:
        chunks = torch.tensor(kw["chunks"], dtype=torch.int32, device=cuda)
    g8 = torch.randn(acc.shape, generator=torch.Generator().manual_seed(10)
                     ).to(cuda)
    args = (gdense, cnt, acc, g8, chunks, kw["tiles_x"], axis)
    out = sorted_bwd.sorted_bwd(*args)
    again = sorted_bwd.sorted_bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)          # deterministic: no atomics
    blocks = launched_blocks(lambda: sorted_bwd.sorted_bwd(*args),
                             "sorted_bwd_kernel")
    assert blocks > n_tiles                 # a cluster of blocks per tile
    ref = sorted_bwd.sorted_bwd_plain(*args)
    assert_sorted_moments_close(out.cpu(), ref.cpu())
    rows = out.reshape(n_tiles, -1, 16).cpu()
    for t, (c, k) in enumerate(zip(kw["cnt"], chunks.tolist())):
        assert not rows[t, min(c, 512 * k):].any()
        if min(c, 512 * k):
            assert rows[t, :min(c, 512 * k)].any()


# K3's culling at its edges: a 2x2 tile grid of cap 1024 with lists of 700,
# 1024, 530 and 0 slots.
CULL_EDGE_TILES_X = 2
CULL_EDGE_CNT = (700, 1024, 530, 0)


def cull_edge_lists(axis, nonfinite=False, seed=11):
    """Slot lists at the edges of K3's culling rule, as numpy (gdense
    (4*CAP, 16), cnt (4,), kind (4*CAP,) of str), each slot of kind
    - "thin": 0.3-1.5 px across and 8-60 px long (rotated for EWA, along x
      or y for the axis footprint), centred within 1.5 px of a boundary
      between two warps' columns and 1 px of one between two blocks' rows;
    - "near": op 1e-5 times 1 + 1e-3, 1 + 1e-6, 1, 1 - 1e-6 or 1 - 1e-3,
      centred on a pixel centre or between four;
    - "opaque": op 1;
    - "none": op 0 or -0.1;
    - "nonpd": a < 0 or c = 0 (and b^2 > ac for EWA), three slots late in
      tile 1's list (they cover the tile at the clamp, 0.9999; none whose
      row factor grows, where the twin's exponent floor on the column
      factor (kernels/sorted_fwd.EXP_FLOOR) would part it from any kernel);
    - "nonfinite": a NaN px, a, op or an infinite c, four slots in tile 2,
      only with nonfinite=True (the twin then gives NaN, the kernel the
      clamp: not for comparing the two);
    - "dead": the rows past cnt."""
    rng = np.random.default_rng(seed)
    n_tiles = len(CULL_EDGE_CNT)
    gd = np.zeros((n_tiles, CAP, 16), np.float32)
    gd[..., 2] = gd[..., 4] = 1.0                      # dead row: op 0
    kind = np.full((n_tiles, CAP), "dead", dtype=object)

    def conic(sx, sy, theta):
        cos, sin = np.cos(theta), np.sin(theta)
        a = cos * cos / sx ** 2 + sin * sin / sy ** 2
        c = sin * sin / sx ** 2 + cos * cos / sy ** 2
        b = cos * sin * (1.0 / sx ** 2 - 1.0 / sy ** 2)
        return a, (0.0 if axis else b), c

    for t, m in enumerate(CULL_EDGE_CNT):
        x0, y0 = (t % CULL_EDGE_TILES_X) * 128, (t // CULL_EDGE_TILES_X) * 16
        kinds = rng.choice(["thin", "near", "opaque", "none"], m,
                           p=[0.68, 0.25, 0.02, 0.05]).astype(object)
        if t == 1:
            kinds[m - 40:m - 10:10] = "nonpd"
        if t == 2 and nonfinite:
            kinds[100:140:10] = "nonfinite"
        for s, k in enumerate(kinds):
            row = gd[t, s]
            row[6:9] = rng.uniform(0, 1, 3)
            row[9] = 1.0
            row[10] = rng.uniform(1.0, 4.0)
            if k == "thin":
                long, short = rng.uniform(8, 60), rng.uniform(0.3, 1.5)
                if axis:
                    sx, sy = (long, short) if rng.uniform() < 0.5 else (
                        short, long)
                    a, b, c = conic(sx, sy, 0.0)
                else:
                    a, b, c = conic(long, short, rng.uniform(0, np.pi))
                row[0] = x0 + 32 * rng.integers(0, 5) + rng.uniform(-1.5, 1.5)
                row[1] = y0 + 2 * rng.integers(0, 9) + rng.uniform(-1, 1)
                row[5] = rng.uniform(0.05, 0.6)
            elif k == "near":
                a, b, c = conic(rng.uniform(0.5, 5), rng.uniform(0.5, 5),
                                rng.uniform(0, np.pi))
                row[0] = x0 + rng.integers(0, 128) + rng.choice([0.5, 0.0])
                row[1] = y0 + rng.integers(0, 16) + rng.choice([0.5, 0.0])
                row[5] = 1e-5 * rng.choice(
                    [1 + 1e-3, 1 + 1e-6, 1.0, 1 - 1e-6, 1 - 1e-3])
            else:
                a, b, c = conic(rng.uniform(1, 6), rng.uniform(1, 6),
                                rng.uniform(0, np.pi))
                row[0] = x0 + rng.uniform(-8, 136)
                row[1] = y0 + rng.uniform(-8, 24)
                row[5] = {"opaque": 1.0, "none": rng.choice([0.0, -0.1]),
                          "nonpd": 0.3, "nonfinite": 0.5}[k]
            row[2:5] = a, b, c
            kind[t, s] = k
        for j, s in enumerate(np.flatnonzero(kinds == "nonpd")):
            gd[t, s, 2:5] = [(-0.01, 0.0, 0.02), (-0.5, 0.0, 0.02),
                             (0.02, 0.0 if axis else 0.05, 0.0)][j]
        for j, s in enumerate(np.flatnonzero(kinds == "nonfinite")):
            field, value = [(0, np.nan), (2, np.nan), (4, np.inf),
                            (5, np.inf)][j]
            gd[t, s, field] = value
    return (gd.reshape(-1, 16), np.array(CULL_EDGE_CNT, np.int32),
            kind.reshape(-1))


def sorted_fwd_edge_inputs(case, axis, device):
    """(gdense, cnt, tiles_x) on `device`: K4's edge case `case` (its lists
    at seed 9), or "cull_edges" (cull_edge_lists, all finite)."""
    if case == "cull_edges":
        gd, cnt, _ = cull_edge_lists(axis)
        tiles_x = CULL_EDGE_TILES_X
    else:
        kw = SORTED_EDGE_CASES[case]
        tiles_x = kw["tiles_x"]
        gd, cnt = slot_lists(tiles_x, kw["tiles_y"], kw["cnt"], axis,
                             [(0.01, 0.2), (0.5, 0.95)] * len(kw["cnt"]),
                             seed=9)
    return (torch.from_numpy(gd).to(device), torch.from_numpy(cnt).to(device),
            tiles_x)


@pytest.mark.cuda
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("case", sorted(SORTED_EDGE_CASES) + ["cull_edges"])
def test_sorted_fwd_kernel_edges(cuda, case, footprint):
    """K3 on K4's edge lists and at its culling rule's edges: a cluster of
    sorted_fwd.CLUSTER blocks per tile, two launches bit for bit, and its
    twin at the exit-aware tolerance above."""
    axis = footprint == "axis"
    gdense, cnt, tiles_x = sorted_fwd_edge_inputs(case, axis, cuda)

    def k3():
        return sorted_fwd.sorted_tiles(gdense, cnt, tiles_x, axis=axis)

    acc, chunks = k3()
    again, chunks_again = k3()
    torch.cuda.synchronize()
    assert torch.equal(acc, again) and torch.equal(chunks, chunks_again)
    blocks = launched_blocks(k3, "sorted_fwd_kernel")
    assert blocks == sorted_fwd.CLUSTER * cnt.shape[0]
    ref, ref_chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x,
                                                    axis=axis)
    assert bool(torch.isfinite(acc).all())
    assert_sorted_fwd_close(acc, chunks, ref, ref_chunks, 1e-6)


def binner_lists(footprint, device, n=8000, width=256, height=64, seed=5):
    """(gdense, cnt, tiles_x): the port's binner lists (2 x 4 tiles at the
    default capacity, 2048; the middle four full) of a seeded scene of
    small gaussians, seeded quaternions for the EWA footprint."""
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.005, 0.05, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    if footprint == "ewa":
        arr["quats"] = rng.normal(size=(n, 4)).astype(np.float32)
    g = gaussians_from_numpy(arr, device=device)
    c = tcam.orbit_cameras(4, width, height, device=device)[1]
    with torch.no_grad():
        s = prepare_splats(g, c.view, c.proj, width, height,
                           footprint=footprint)
        gdense, cnt, tiles_x, _, _ = tsorted.tile_lists(
            s, camera_z(g.means, c.view), height, width)
    return gdense, cnt, tiles_x


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("case", ["cull_edges", "binner"])
def test_sorted_bwd_kernel_culls_exactly(cuda, case, footprint, early_exit):
    """K4 at its culling rule's edges (cull_edge_lists, all finite) and on
    binner lists, over every chunk K3 composited or one chunk fewer a tile
    (an early exit): its twin at K4's tolerance, two launches bit for bit
    (the second under a profiler, which gives the kernel its walk
    counter), and the counter's two values those of the CPU mirror
    (`sorted_bwd.walk_counts`) exactly."""
    axis = footprint == "axis"
    if case == "binner":
        gdense, cnt, tiles_x = binner_lists(footprint, cuda)
    else:
        gdense, cnt, tiles_x = sorted_fwd_edge_inputs(case, axis, cuda)
    acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, tiles_x, axis=axis)
    if early_exit:
        chunks = torch.clamp(chunks - 1, min=0)
    g8 = torch.randn(acc.shape, generator=torch.Generator().manual_seed(12)
                     ).to(cuda)
    args = (gdense, cnt, acc, g8, chunks, tiles_x, axis)
    out = sorted_bwd.sorted_bwd(*args)
    before = len(profiling.counters())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        again = sorted_bwd.sorted_bwd(*args)
        torch.cuda.synchronize()
    assert torch.equal(out, again)          # deterministic: no atomics
    ref = sorted_bwd.sorted_bwd_plain(*args)
    assert_sorted_moments_close(out.cpu(), ref.cpu())
    records = profiling.counters()[before:]
    assert [r.name for r in records] == ["gs.composite.bwd.walks"]
    walked, slots = records[0].value.tolist()
    assert (walked, slots) == sorted_bwd.walk_counts(
        gdense.cpu(), cnt.cpu(), chunks.cpu(), tiles_x, axis)
    assert slots == 32 * int(torch.minimum(cnt, chunks * 512).sum())
    assert walked < slots or slots == 0


@pytest.mark.cuda
def test_sorted_bwd_counts_walks_only_under_a_profiler(cuda):
    """No profiler: K4's wrapper allocates the rows alone and records no
    counter. Under one: the rows and the counter pair, and one record."""
    gdense, cnt = synthetic_lists(False, device=cuda)
    acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, TILES_X)
    g8 = torch.randn(acc.shape, generator=torch.Generator().manual_seed(13)
                     ).to(cuda)
    args = (gdense, cnt, acc, g8, chunks, TILES_X, False)
    sorted_bwd.sorted_bwd(*args)
    torch.cuda.synchronize()

    def allocations():
        return torch.cuda.memory_stats()["allocation.all.allocated"]

    for traced, made, recorded in ((False, 1, 0), (True, 2, 1)):
        n_alloc, n_rec = allocations(), len(profiling.counters())
        if traced:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                sorted_bwd.sorted_bwd(*args)
        else:
            assert not profiling.active()
            sorted_bwd.sorted_bwd(*args)
        torch.cuda.synchronize()
        assert allocations() - n_alloc == made
        assert len(profiling.counters()) - n_rec == recorded


@pytest.mark.cuda
def test_checkpoint_from_a_cuda_fit_restores_on_cuda(cuda, tmp_path):
    """A fit on the card checkpoints every 5 steps; its last checkpoint
    restores onto the card equal to the fit's final parameters, Adam's
    moments on the card and its step counts on the host; a resumed fit
    runs on from it."""
    import dataclasses

    from tpu_gaussians_torch.fit import trainer
    from tpu_gaussians_torch.fit.step import make_optimizer
    from tpu_gaussians_torch.io.checkpoint import Checkpointer
    from tpu_gaussians_torch.utils.config import FitConfig

    w = h = 32
    targets = np.random.default_rng(0).uniform(
        size=(2, h, w, 3)).astype(np.float32)
    cams = tcam.orbit_cameras(2, w, h, device=cuda)
    cfg = FitConfig(iters=10, width=w, height=h, num_gaussians=12,
                    max_gaussians=16, densify_interval=0, prune_interval=0,
                    silhouette_weight=0.0, log_every=1000,
                    checkpoint_every=5)
    result = trainer.fit(cfg, targets, cams, out_dir=tmp_path, device=cuda)
    step, state, gen_state = Checkpointer(tmp_path / "checkpoints").restore(
        make_optimizer(cfg.lr), cuda)
    assert step == 10 and gen_state.device.type == "cpu"
    for k, t in state.raw.trainable().items():
        assert t.device.type == "cuda"
        assert torch.equal(t, getattr(result.raw, k))
    for s in state.opt.state.values():
        assert s["exp_avg"].device.type == "cuda"
        assert s["step"].device.type == "cpu" and float(s["step"]) == 10.0
    resumed = trainer.fit(dataclasses.replace(cfg, iters=15, resume=True),
                          targets, cams, out_dir=tmp_path, device=cuda)
    assert len(resumed.loss_log) == 5
    assert resumed.raw.means.device.type == "cuda"


@pytest.mark.cuda
def test_interpret_mode_runs_the_plain_twins_on_cuda(cuda):
    """Under utils.debug.interpret_mode a wrapper launches nothing and
    returns its twin's output bit for bit, on CUDA tensors; outside it the
    same call launches the kernel."""
    from tpu_gaussians_torch.utils.debug import interpret_mode

    lo, cnt, gdata, rows, wp, nb = sep_case("flagship_shape", cuda)
    gdense, counts = synthetic_lists(True, device=cuda)
    before, before_k3 = dict(splat_sep.launches), sorted_fwd.launches
    with interpret_mode():
        acc = splat_sep.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
        k3, k3_chunks = sorted_fwd.sorted_tiles(gdense, counts, TILES_X,
                                                axis=True)
    assert splat_sep.launches == before and sorted_fwd.launches == before_k3
    assert acc.device.type == "cuda"
    assert torch.equal(acc, splat_sep.sep_fwd_plain(lo, cnt, gdata, rows, wp,
                                                    nb))
    ref, ref_chunks = sorted_fwd.sorted_tiles_plain(gdense, counts, TILES_X,
                                                    axis=True)
    assert torch.equal(k3, ref) and torch.equal(k3_chunks, ref_chunks)
    splat_sep.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
    sorted_fwd.sorted_tiles(gdense, counts, TILES_X, axis=True)
    torch.cuda.synchronize()
    assert splat_sep.launches["splat_sep_fwd"] == before["splat_sep_fwd"] + 1
    assert sorted_fwd.launches == before_k3 + 1


def _raw_inputs(prefix, raw):
    return {f"{prefix}/{k}": t.cpu().numpy() for k, t in vars(raw).items()
            if t is not None}


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_the_single_step(cuda, tmp_path):
    """The parallel tests' cases on two gloo ranks that share the card
    (tests/torch_port_rank_worker.py; gloo stages the all-reduce through
    the host): every sharded step against its factory's single-rank step
    at tests/test_sharded.py's _assert_states_match tolerances (loss rtol
    1e-5 / atol 1e-6, leaves rtol 2e-4 / atol 2e-6), the kernels (impl
    "tiled") in the three modes among them, and both ranks' parameters
    bit-identical."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tpu_gaussians_torch.models.gaussian_model import init_params

    root = Path(__file__).resolve().parent.parent
    inputs = {
        **_raw_inputs("raw", init_params(torch.Generator().manual_seed(0),
                                         24, 32, device="cpu")),
        **_raw_inputs("fit_raw", init_params(
            torch.Generator().manual_seed(4), 16, 24, device="cpu")),
        "targets": np.random.default_rng(0).uniform(
            size=(8, 32, 16, 3)).astype(np.float32),
        "fit_targets": np.random.default_rng(1).uniform(
            size=(8, 32, 16, 3)).astype(np.float32)}
    np.savez(tmp_path / "in.npz", **inputs)
    worker = root / "tests" / "torch_port_rank_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(tmp_path / "store"), str(r), "2",
         str(tmp_path / "in.npz"), str(tmp_path), "cuda"], cwd=root,
        env={**os.environ, "OMP_NUM_THREADS": "1"}, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    leaves = ("means", "scales_raw", "opacities_raw", "colors_raw")
    pairs = [(f"{f}/{m}/ssim{s}", f"{f}/single/ssim{s}")
             for f in ("sharded", "shardmap", "overlapped1", "overlapped2",
                       "overlapped4")
             for m in ("views", "rows") for s in (0.0, 0.2)]
    pairs += [(f"tiled_{mode}/{f}/views", f"tiled_{mode}/{f}/single")
              for mode in ("accum_off", "accum_on", "sorted_off")
              for f in ("sharded", "shardmap")]
    for case, single in pairs:
        np.testing.assert_allclose(res[0][f"{case}/metric/loss"],
                                   res[0][f"{single}/metric/loss"],
                                   rtol=1e-5, atol=1e-6, err_msg=case)
        for leaf in leaves:
            np.testing.assert_allclose(res[0][f"{case}/{leaf}"],
                                       res[0][f"{single}/{leaf}"],
                                       rtol=2e-4, atol=2e-6,
                                       err_msg=f"{case} {leaf}")
    for k in res[0]:
        if not k.startswith("layout"):
            np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    losses = res[0]["ten_steps/losses"]
    assert losses[-1] < losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["accum", "sorted"])
def test_render_tiled_on_one_card_named_twice(cuda, mode):
    """render_tiled with its bands on cuda:0 named twice (they render in
    turn) and in 3 bands (50 rows are not divisible by 3) against the
    whole-frame render through the same kernels, rtol / atol 2e-5 with the
    aux outputs (tests/test_tiled_render.py). 3,000 gaussians overfill the
    sorted tiles (pairs dropped at capacity): bands of whole tile rows drop
    the same ones."""
    from tpu_gaussians_torch.parallel.tiled import render_tiled

    rng = np.random.default_rng(2)
    g = gaussians_from_numpy(dict(
        means=rng.uniform(-0.6, 0.6, (3000, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.1, (3000, 3)).astype(np.float32),
        colors=rng.uniform(0, 1, (3000, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (3000,)).astype(np.float32)),
        device=cuda)
    c = tcam.orbit_cameras(4, 64, 50, device=cuda)[1]
    cfg = RenderConfig(width=64, height=50, mode=mode, return_aux=True)
    with torch.no_grad():
        full = render(g, c, cfg)
        for devices in (["cuda:0", "cuda:0"], [cuda] * 3):
            tiled = render_tiled(g, c, cfg, devices=devices)
            for a, b in zip(tiled, full):
                assert a.shape == b.shape and a.device == b.device
                torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def stage_inputs(n, ewa, sh_k, device, seed=0):
    """The benchmark's kind of scene (means U(-1,1), scales U(0.005,0.03),
    opacities U(0.2,0.9), N(0,1) quaternions, SH DC U(0,1) and higher rows
    N(0,0.1)) with a tenth of it dead, and view 1 of 4 orbit cameras at
    1920x1080: the stage's arguments (means ... proj)."""
    rng = np.random.default_rng(seed)
    sh = rng.normal(0.0, 0.1, (n, sh_k, 3))
    sh[:, 0] = rng.uniform(0.0, 1.0, (n, 3))
    arrs = (rng.uniform(-1.0, 1.0, (n, 3)), rng.uniform(0.005, 0.03, (n, 3)),
            rng.normal(size=(n, 4)) if ewa else None, sh,
            rng.uniform(0.2, 0.9, n), (rng.uniform(size=n) > 0.1))
    t = [None if a is None else torch.from_numpy(
        np.asarray(a, np.float32)).to(device) for a in arrs]
    c = tcam.orbit_cameras(4, 1920, 1080, device=device)[1]
    return t + [c.view, c.proj]


def stage_err(x, ref, rows):
    """Worst error of x against ref (float64), relative to the largest
    |ref| of its field (rows: each of the 8 rows and each feats column) or
    of its gaussian (gradients: the gaussian's largest of that leaf)."""
    ref = ref.double()
    if rows:
        scale = ref.abs().amax(dim=1 if ref.shape[0] == 8 else 0,
                               keepdim=True)
    else:
        n = ref.shape[0]
        scale = ref.abs().reshape(n, -1).amax(dim=1).reshape(
            (n,) + (1,) * (ref.ndim - 1))
    return float(((x.double() - ref).abs() / scale.clamp(min=1e-30)).max())


def assert_stage_close(got, twin, exact, what):
    for k, (a, b, r) in enumerate(zip(got, twin, exact)):
        if r is None:
            assert a is None and b is None
            continue
        rows = what == "forward"
        e_k, e_t = stage_err(a, r, rows), stage_err(b, r, rows)
        assert e_k <= 4.0 * e_t + 1e-6, (what, k, e_k, e_t)


@pytest.mark.cuda
@pytest.mark.parametrize("n,ewa,sh_k", [(100_000, True, 16),
                                        (1_000_000, False, 4)])
def test_stage_kernels_match_plain_twins(cuda, n, ewa, sh_k):
    """The stage's forward and backward kernels against their twins at the
    benchmark's sizes (100k EWA SH3, 1M axis SH1), and bit for bit across
    two launches. The backward takes strided cotangents (columns of one
    (N, 16) buffer, as the sorted route's gather hands them back) and one
    None."""
    ins = stage_inputs(n, ewa, sh_k, cuda)
    ins64 = [None if t is None else t.double() for t in ins]
    args = (1920, 1080, ewa, sh_k)
    before = dict(stage.launches)
    rows, feats = stage._fwd(ins, *args)
    rows2, feats2 = stage._fwd(ins, *args)
    torch.cuda.synchronize()
    assert torch.equal(rows, rows2) and torch.equal(feats, feats2)
    twin = stage.stage_fwd_plain(*ins, 1920, 1080, ewa)
    exact = stage.stage_fwd_plain(*ins64, 1920, 1080, ewa)
    assert_stage_close([rows, feats], twin, exact, "forward")

    buf = torch.randn((n, 16), generator=torch.Generator().manual_seed(1)
                      ).to(cuda)
    cot = [buf[:, k] for k in range(8)] + [buf[:, 8:13]]
    cot[6] = None
    needs = [t is not None for t in ins[:5]]
    got = stage._bwd(ins, *args, cot, needs)
    got2 = stage._bwd(ins, *args, cot, needs)
    torch.cuda.synchronize()
    assert stage.launches == {"stage_fwd": before["stage_fwd"] + 2,
                              "stage_bwd": before["stage_bwd"] + 2}
    for a, b in zip(got, got2):
        assert (a is None and b is None) or torch.equal(a, b)
    twin = stage.stage_bwd_plain(*ins, 1920, 1080, ewa, cot, needs)
    exact = stage.stage_bwd_plain(
        *ins64, 1920, 1080, ewa,
        [None if g is None else g.double() for g in cot], needs)
    assert_stage_close(got, twin, exact, "backward")


def stage_step(device, n=3000, side=256):
    """A sorted EWA SH3 training step of 4 views: (its loss function's
    arguments, the raw leaves)."""
    from tpu_gaussians_torch.fit.loss import LossConfig
    from tpu_gaussians_torch.models.gaussian_model import init_params

    gen = torch.Generator().manual_seed(0)
    raw = init_params(gen, n, n, True, use_quats=True, sh_degree=3,
                      device=device)
    # Rotated, anisotropic splats (the init's are identity and round,
    # where the quaternions' gradient vanishes).
    leaves = dict(raw.trainable())
    leaves["quats_raw"] = torch.randn((n, 4), generator=gen).to(device)
    leaves["scales_raw"] = leaves["scales_raw"] + torch.randn(
        (n, 3), generator=gen).to(device)
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in leaves.items()}
    raw = raw.with_trainable(leaves)
    cams = tcam.orbit_cameras(4, side, side, device=device)
    rng = np.random.default_rng(0)
    targets = torch.from_numpy(rng.uniform(0, 1, (4, side, side, 3)).astype(
        np.float32)).to(device)
    cfg = RenderConfig(width=side, height=side, mode="sorted",
                       footprint="ewa", sorted_pair_k=16)
    return (raw, cams, targets, None, None, cfg, LossConfig()), leaves


@pytest.mark.cuda
def test_stage_launches_once_a_view_each_way(cuda, tmp_path):
    """A sorted 4-view training step launches the stage's forward 4 times
    and its backward 4 times; a served frame launches its forward once."""
    from tpu_gaussians_torch.cli.serve import RenderService
    from tpu_gaussians_torch.fit.loss import loss_fn
    from tpu_gaussians_torch.io.npz import save_gaussians_npz

    args, _ = stage_step(cuda)
    before = dict(stage.launches)
    loss_fn(*args)[0].backward()
    torch.cuda.synchronize()
    assert stage.launches == {"stage_fwd": before["stage_fwd"] + 4,
                              "stage_bwd": before["stage_bwd"] + 4}
    rng = np.random.default_rng(1)
    save_gaussians_npz(tmp_path / "g.npz", gaussians_from_numpy(dict(
        means=rng.uniform(-1, 1, (5000, 3)).astype(np.float32),
        scales=rng.uniform(0.005, 0.03, (5000, 3)).astype(np.float32),
        colors=rng.uniform(0, 1, (5000, 3)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.9, 5000).astype(np.float32)),
        device="cpu"))
    svc = RenderService(str(tmp_path / "g.npz"), device="cuda")
    svc.render_frame(0.5, 0.2, 2.5, 320, 240, "sorted")
    before = dict(stage.launches)
    svc.render_frame(0.6, 0.2, 2.5, 320, 240, "sorted")
    assert stage.launches == {"stage_fwd": before["stage_fwd"] + 1,
                              "stage_bwd": before["stage_bwd"]}


@pytest.mark.cuda
def test_stage_step_grads_match_the_plain_composition(cuda, monkeypatch):
    """A sorted EWA SH3 step's loss and leaf gradients through the stage's
    kernels against the same step with the stage's plain composition under
    autograd in its place (the stage as it was before the kernels)."""
    from tpu_gaussians_torch.fit.loss import loss_fn
    from tpu_gaussians_torch.ops import common

    def plain(means, scales, quats, colors, opacities, alive, view, proj,
              width, height, ewa):
        rows, feats = stage.stage_fwd_plain(means, scales, quats, colors,
                                            opacities, alive, view, proj,
                                            width, height, ewa)
        return (*rows.unbind(0), feats)

    out = {}
    for name in ("kernels", "plain"):
        if name == "plain":
            monkeypatch.setattr(common, "stage", plain)
        args, leaves = stage_step(cuda)
        loss = loss_fn(*args)[0]
        loss.backward()
        out[name] = [loss.detach()] + [leaves[k].grad for k in sorted(leaves)]
    for a, b in zip(out["kernels"], out["plain"]):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-3, atol=2e-4 * scale)

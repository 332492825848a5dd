"""The compositing kernels' culling rule, on the CPU: `kernels/sorted_fwd`'s
`slot_extent` and `cull_blocks`, the torch mirror of what
`csrc/sorted_fwd.cu` (K3) and `csrc/sorted_bwd.cu` (K4) skip.

K3 skips a (slot, pixel) pair only where a_raw < 1e-5, where evaluating it
adds 0 and multiplies T by 1. So the rule must hold every pair that the
twin's `slot_alpha` finds at or above the cutoff inside the slot's extent,
and zeroing a_raw outside the extents must leave `sorted_tiles_plain`'s
output and chunks_done the same bit for bit, and `sorted_bwd_plain`'s raw
rows equal. Both are held on the port's binner lists of a small seeded
scene and on `cull_edge_lists`' adversarial slots (thin rotated conics
across warp and row-pair boundaries, op at the cutoff, op 1, conics that
are not positive definite, non-finite values)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import gaussians_from_numpy
from tpu_gaussians_torch.kernels import sorted_bwd, sorted_fwd
from tpu_gaussians_torch.ops import sorted as tsorted
from tpu_gaussians_torch.ops.binning import ALPHA_CUTOFF, TH, TWC
from tpu_gaussians_torch.ops.common import prepare_splats
from tpu_gaussians_torch.ops.projection import camera_z

from .test_torch_port_cuda import CULL_EDGE_TILES_X, cull_edge_lists


def scene_lists(footprint, n=400, width=256, height=48, seed=5, cap=512):
    """The port's binner lists (2 x 3 tiles, capacity `cap`) of a small
    seeded scene; seeded quaternions for the EWA footprint."""
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, 0.12, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    if footprint == "ewa":
        arr["quats"] = rng.normal(size=(n, 4)).astype(np.float32)
    g = gaussians_from_numpy(arr, device="cpu")
    c = tcam.orbit_cameras(4, width, height, device="cpu")[1]
    s = prepare_splats(g, c.view, c.proj, width, height, footprint=footprint)
    gdense, cnt, tiles_x, _, _ = tsorted.tile_lists(
        s, camera_z(g.means, c.view), height, width, band_capacity=cap,
        pair_k=8)
    return gdense, cnt, tiles_x, None


def lists(case, footprint, nonfinite=False):
    """(gdense, cnt, tiles_x, kind or None) of a case."""
    if case == "scene":
        return scene_lists(footprint)
    gd, cnt, kind = cull_edge_lists(footprint == "axis", nonfinite=nonfinite)
    return (torch.from_numpy(gd), torch.from_numpy(cnt), CULL_EDGE_TILES_X,
            kind)


def tile_origins(gx, gy):
    """The first column and row of each tile, from tile_pixels' centres."""
    return (gx[:, 0] - 0.5).long(), (gy[:, 0] - 0.5).long()


def cull_pixels(blocks):
    """cull_blocks' (T, m, CLUSTER, WARPS) -> (T, m, TPS): whether the
    kernel evaluates each (slot, pixel); pixel l at row l // 128, column
    l % 128."""
    px = blocks.repeat_interleave(TH // sorted_fwd.CLUSTER, dim=2)
    px = px.repeat_interleave(sorted_fwd.WARP_COLS, dim=3)   # (T, m, TH, TWC)
    return px.reshape(*blocks.shape[:2], TH * TWC)


def inside(gd, dx, dy, axis):
    """(T, m, TPS): the pixels inside each slot's extent."""
    ex, ey = sorted_fwd.slot_extent(gd, axis)
    never = (torch.isinf(ex) & (ex > 0))[..., None]
    return never | ((dx.abs() <= ex[..., None]) & (dy.abs() <= ey[..., None]))


@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("case", ["scene", "adversarial"])
def test_live_pairs_lie_inside_the_extent(case, footprint):
    axis = footprint == "axis"
    gdense, cnt, tiles_x, kind = lists(case, footprint, nonfinite=True)
    n_tiles = cnt.shape[0]
    g = gdense.reshape(n_tiles, -1, 16)
    gx, gy = sorted_fwd.tile_pixels(n_tiles, tiles_x, "cpu")
    a_raw, dx, dy = sorted_fwd.slot_alpha(g, gx, gy, axis)
    live = a_raw >= ALPHA_CUTOFF
    assert not bool((live & ~inside(g, dx, dy, axis)).any())
    evaluated = cull_pixels(sorted_fwd.cull_blocks(
        g, *tile_origins(gx, gy), axis))
    assert not bool((live & ~evaluated).any())
    # The rule culls: listed slots are evaluated over a small part of their
    # tile (the scene's about 12%; many adversarial conics are too thin to
    # cull), and live pairs exist to be kept.
    listed = (torch.arange(g.shape[1])[None, :] < cnt[:, None].long())
    assert int(live[listed].sum()) > 0
    share = float(evaluated[listed].float().mean())
    assert share < (0.25 if case == "scene" else 0.75)

    ex, _ = sorted_fwd.slot_extent(g, axis)
    if kind is not None:
        kind = kind.reshape(n_tiles, -1)
        never = torch.isinf(ex) & (ex > 0)
        nothing = torch.isinf(ex) & (ex < 0)
        for k in ("nonpd", "nonfinite"):
            assert bool(never[torch.from_numpy(kind == k)].all()), k
        assert bool(nothing[torch.from_numpy(kind == "none")].all())
        assert bool(nothing[torch.from_numpy(kind == "dead")].all())
        # op at or just above the cutoff, centred on a pixel: live there
        near = torch.from_numpy(kind == "near")
        centred = (g[..., 0] % 1 == 0.5) & (g[..., 1] % 1 == 0.5)
        above = g[..., 5] >= ALPHA_CUTOFF
        assert bool(live.any(-1)[near & centred & above].all())
        assert bool((~live.any(-1))[near & ~above].all())
        # both sides of the det threshold among the thin conics
        thin = torch.from_numpy(kind == "thin")
        assert bool(never[thin].any()) or axis
        assert bool((~never & thin).any())


@pytest.mark.parametrize("granularity", ["pixel", "warp"])
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("case", ["scene", "adversarial"])
def test_culled_twin_is_bit_identical(case, footprint, granularity,
                                      monkeypatch):
    """a_raw set to 0 outside each slot's extent ("pixel") or outside the
    blocks and warps the kernel evaluates it in ("warp"): acc and
    chunks_done bit for bit the twin's."""
    axis = footprint == "axis"
    gdense, cnt, tiles_x, _ = lists(case, footprint)
    ref, ref_chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x,
                                                    axis=axis)
    plain = sorted_fwd.slot_alpha
    zeroed = []

    def culled(gd, gx, gy, axis_):
        a_raw, dx, dy = plain(gd, gx, gy, axis_)
        if granularity == "pixel":
            keep = inside(gd, dx, dy, axis_)
        else:
            keep = cull_pixels(sorted_fwd.cull_blocks(
                gd, *tile_origins(gx, gy), axis_))
        zeroed.append(int(((a_raw > 0) & ~keep).sum()))
        return torch.where(keep, a_raw, torch.zeros_like(a_raw)), dx, dy

    monkeypatch.setattr(sorted_fwd, "slot_alpha", culled)
    acc, chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x,
                                                axis=axis)
    assert sum(zeroed) > 0              # the culling removed nonzero alphas
    assert torch.equal(chunks, ref_chunks)
    assert torch.equal(acc, ref)


def test_cull_counts_match_the_masks():
    """cull_counts over a launch's composited slots: live <= evaluated <=
    composited, the evaluated pairs a multiple of a block's warp (2 rows of
    32 columns), and the counts of one tile batch equal to those of many."""
    gdense, cnt, tiles_x, _ = scene_lists("ewa")
    _, chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x)
    whole = sorted_fwd.cull_counts(gdense, cnt, chunks, tiles_x, False)
    split = sorted_fwd.cull_counts(gdense, cnt, chunks, tiles_x, False,
                                   tiles_per_batch=1)
    assert whole == split
    assert 0 < whole["live_pairs"] <= whole["evaluated_pairs"]
    assert whole["evaluated_pairs"] < whole["composited_pairs"]
    assert whole["evaluated_pairs"] % ((TH // sorted_fwd.CLUSTER) * 32) == 0
    assert whole["composited_pairs"] == int(torch.minimum(
        cnt, chunks * 512).sum()) * TH * TWC


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("case", ["scene", "adversarial"])
def test_culled_backward_twin_is_equal(case, footprint, early_exit,
                                       monkeypatch):
    """K4's walk culled as the kernel culls it: a_raw set to 0 outside the
    blocks and warps that list each slot leaves `sorted_bwd_plain`'s raw
    rows equal (==), over every chunk K3's twin composited or with
    chunks_done one below each tile's chunk count (an early exit; there
    the scene is denser, at capacity 1024, so that each tile composites
    one of its two chunks). The mirror's counter values: the kept (slot,
    block, warp) walks over the composited slots, and composited slots x
    32."""
    axis = footprint == "axis"
    if case == "scene" and early_exit:
        gdense, cnt, tiles_x, _ = scene_lists(footprint, n=2000, cap=1024)
    else:
        gdense, cnt, tiles_x, _ = lists(case, footprint)
    acc, chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x,
                                                axis=axis)
    if early_exit:
        chunks = torch.clamp(chunks - 1, min=0)
    g8 = torch.randn(acc.shape, generator=torch.Generator().manual_seed(6))
    args = (gdense, cnt, acc, g8, chunks, tiles_x, axis)
    ref = sorted_bwd.sorted_bwd_plain(*args)
    plain = sorted_bwd.slot_alpha
    zeroed = []

    def culled(gd, gx, gy, axis_):
        a_raw, dx, dy = plain(gd, gx, gy, axis_)
        keep = cull_pixels(sorted_fwd.cull_blocks(
            gd, *tile_origins(gx, gy), axis_))
        zeroed.append(int(((a_raw > 0) & ~keep).sum()))
        return torch.where(keep, a_raw, torch.zeros_like(a_raw)), dx, dy

    monkeypatch.setattr(sorted_bwd, "slot_alpha", culled)
    out = sorted_bwd.sorted_bwd_plain(*args)
    limit = torch.minimum(cnt, chunks * 512).long()
    composited = int(limit.sum())
    assert composited > 0
    assert sum(zeroed) > 0              # the culling removed nonzero alphas
    assert bool((out == ref).all())

    n_tiles = cnt.shape[0]
    g = gdense.reshape(n_tiles, -1, 16)
    gx, gy = sorted_fwd.tile_pixels(n_tiles, tiles_x, "cpu")
    blocks = sorted_fwd.cull_blocks(g, *tile_origins(gx, gy), axis)
    used = torch.arange(g.shape[1])[None, :] < limit[:, None]
    kept = int((blocks & used[..., None, None]).sum())
    walked, slots = sorted_bwd.walk_counts(gdense, cnt, chunks, tiles_x,
                                           axis)
    assert (walked, slots) == (kept, composited * 32)
    assert walked < slots


def cu_rule(name):
    """The culling rule's text in csrc/<name>.cu: warp_mask's definition
    and the constants it reads."""
    src = (Path(sorted_fwd.__file__).parent.parent / "csrc"
           / f"{name}.cu").read_text()
    body = re.search(r"__device__ __forceinline__ int warp_mask\(.*?\n}\n",
                     src, re.S).group(0)
    consts = [re.search(rf"constexpr \w+ {c} = [^;]*;", src).group(0)
              for c in ("CULL", "ROW_CULL", "ALL_WARPS", "WARPS",
                        "ALPHA_CUTOFF", "Q_SLACK", "Q_SCALE",
                        "MIN_DET_RATIO", "MARGIN_PX", "TWC")]
    return body, consts


def test_k3_and_k4_cull_by_one_rule():
    """K4's copy of K3's warp_mask and of its constants, letter for
    letter: both kernels skip what the one mirror (`slot_extent`,
    `cull_blocks`) says they skip."""
    assert cu_rule("sorted_bwd") == cu_rule("sorted_fwd")

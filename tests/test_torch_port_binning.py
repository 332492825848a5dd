"""Port parity, tile binner: `tpu_gaussians_torch.ops.binning` against the
JAX binner (`tpu_gaussians/ops/pallas/sorted.py` `_bin_pairs_2d`,
`_tile_rects`, `_zkey_desc`) on identical inputs. The binner is pure
integer selection, so per-tile counts, the overflow stats and the per-tile
lists (as original gaussian ids) must be EQUAL, not close."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import make_gaussians
from tpu_gaussians.ops.common import prepare_splats
from tpu_gaussians.ops.pallas import sorted as PS
from tpu_gaussians.ops.projection import camera_z
from tpu_gaussians_torch.ops import binning as B


def screen_inputs(n, seed, width, height, scale=(0.02, 0.25),
                  opacity=(0.05, 0.95)):
    """(px, py, sigma_x, sigma_y, op_eff, z) numpy arrays of a random scene
    seen by an orbit camera (computed once, fed to both binners)."""
    rng = np.random.default_rng(seed)
    g = make_gaussians(
        rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        rng.uniform(*scale, (n, 3)).astype(np.float32),
        rng.uniform(*opacity, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    c = jcam.orbit_cameras(4, width, height)[1]
    s = prepare_splats(g, c.view, c.proj, width, height)
    return tuple(np.asarray(a) for a in (
        s.px, s.py, s.sigma_x, s.sigma_y, s.op_eff, camera_z(g.means, c.view)))


def bin_both(inputs, width, height, cap, k):
    tiles_x = -(-width // B.TWC)
    tiles_y = -(-height // B.TH)
    n = inputs[0].shape[0]
    order, slots, cnt, stats = PS._bin_pairs_2d(
        *(jnp.asarray(a) for a in inputs), tiles_x, tiles_y, cap, width,
        height, k=k)
    t_slots, t_cnt, t_stats = B.bin_pairs_2d(
        *(torch.from_numpy(a.copy()) for a in inputs), tiles_x, tiles_y,
        cap, width, height, k=k)
    order_ext = np.concatenate([np.asarray(order), [n]])
    j_ids = order_ext[np.asarray(slots)]          # original ids, n = empty
    j_stats = {key: int(v) for key, v in stats.items()}
    t_stats = {key: int(v) for key, v in t_stats.items()}
    return (j_ids, np.asarray(cnt)[0], j_stats), (
        t_slots.numpy(), t_cnt.numpy(), t_stats)


def assert_equal_bins(j, t):
    np.testing.assert_array_equal(t[1], j[1])     # per-tile counts
    assert t[2] == j[2]                           # overflow stats
    np.testing.assert_array_equal(t[0], j[0])     # per-tile lists


@pytest.mark.parametrize("n,seed,width,height,cap,k,expect", [
    # slack: every list fits, full rect coverage (k from the pair budget)
    (300, 0, 256, 48, 512, 0, "slack"),
    # interactive preset at a dense scene: capacity overflow drops pairs
    (2000, 1, 256, 48, 512, 8, "overflow"),
])
def test_bin_pairs_2d_equals_jax(n, seed, width, height, cap, k, expect):
    j, t = bin_both(screen_inputs(n, seed, width, height), width, height,
                    cap, k)
    assert_equal_bins(j, t)
    if expect == "slack":
        assert t[2]["dropped_pairs"] == 0 and t[2]["full_tiles"] == 0
    else:
        assert t[2]["dropped_pairs"] > 0 and t[2]["full_tiles"] > 0


def test_bin_pairs_2d_clipped_rects_equal_jax():
    """Large splats under the k = 8 budget over a 512-wide frame lose true
    overlaps to the rect shrink (clipped_rect_pairs > 0)."""
    inputs = screen_inputs(400, 2, 512, 128, scale=(0.3, 0.8),
                           opacity=(0.5, 0.95))
    j, t = bin_both(inputs, 512, 128, 512, 8)
    assert_equal_bins(j, t)
    assert t[2]["clipped_rect_pairs"] > 0


def test_zkey_desc_is_bit_exact():
    z = np.array([0.0, -0.0, 1.5, -1.5, 1e-30, -1e-30, 3e38, -3e38,
                  np.inf, -np.inf, 2.0, 2.0], np.float32)
    j = np.asarray(PS._zkey_desc(jnp.asarray(z))).astype(np.int64)
    np.testing.assert_array_equal(B.zkey_desc(torch.from_numpy(z)).numpy(),
                                  j)


def test_tile_rects_equal_jax():
    inputs = screen_inputs(500, 3, 256, 64)
    j = PS._tile_rects(*(jnp.asarray(a) for a in inputs[:5]), 2, 4, 8,
                       256, 64)
    t = B.tile_rects(*(torch.from_numpy(a.copy()) for a in inputs[:5]),
                     2, 4, 8, 256, 64)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("n", [1, 1000, 187_500, 1_000_000, 5_000_000])
def test_k_pairs(n):
    assert B.k_pairs(n) == PS._k_pairs(n)

"""The CUDA kernel on the card: `csrc/sorted_fwd.cu` against its plain twin,
and the tiled render against the whole-frame plain renderer. Every test
here needs an NVIDIA GPU and skips without one.

This file imports torch only, so that it runs where JAX is not installed:
  python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: the kernel updates T per gaussian, the twin per 128-slot
sub-block (T *= 1 - sum of contributions), so they round differently:
rtol 1e-4 / atol 1e-5; and on a tile whose whole-tile exit decision fell
on the other side of exit_t, the bound is exit_t itself."""

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig, gaussians_from_numpy
from tpu_gaussians_torch.kernels import sorted_fwd
from tpu_gaussians_torch.ops.dispatch import render

TILES_X, TILES_Y, CAP = 2, 2, 1024


def synthetic_lists(axis, device="cpu", seed=0):
    """Per-tile slot lists in the kernel's input layout: splats spread over
    each tile, 10-40 px wide. Tile 0 is near-opaque and exits early at
    either threshold, tile 1 translucent (never exits), tile 2 mid-way,
    tile 3 short; the empty slots past cnt are the dead row."""
    rng = np.random.default_rng(seed)
    n_tiles = TILES_X * TILES_Y
    gd = np.zeros((n_tiles, CAP, 16), np.float32)
    gd[..., 2] = gd[..., 4] = 1.0                      # dead row: op 0
    cnt = np.array([1024, 1024, 900, 300], np.int32)
    op_range = [(0.9, 0.99), (0.01, 0.05), (0.3, 0.8), (0.5, 0.9)]
    for t in range(n_tiles):
        m = cnt[t]
        x0, y0 = (t % TILES_X) * 128, (t // TILES_X) * 16
        sig = rng.uniform(10.0, 40.0, (m, 2)).astype(np.float32)
        rows = gd[t, :m]
        rows[:, 0] = x0 + rng.uniform(-20, 148, m)
        rows[:, 1] = y0 + rng.uniform(-10, 26, m)
        rows[:, 2] = 1.0 / sig[:, 0] ** 2
        rows[:, 4] = 1.0 / sig[:, 1] ** 2
        if not axis:
            rows[:, 3] = rng.uniform(-0.9, 0.9, m) * np.sqrt(
                rows[:, 2] * rows[:, 4])
        rows[:, 5] = rng.uniform(*op_range[t], m)
        rows[:, 6:9] = rng.uniform(0, 1, (m, 3))
        rows[:, 9] = 1.0
        rows[:, 10] = rng.uniform(1.0, 4.0, m)
    return (torch.from_numpy(gd.reshape(-1, 16)).to(device),
            torch.from_numpy(cnt).to(device))


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

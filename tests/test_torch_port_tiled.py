"""Port parity, tiled (row-band) rendering: `tpu_gaussians_torch.parallel.
tiled.render_tiled` against the port's full-frame render at
tests/test_tiled_render.py's rtol / atol 2e-5 (bands of one frame), and
against `tpu_gaussians.parallel.tiled.render_tiled` on the same scene at
the render parity tolerances of tests/test_torch_port_render.py (image and
alpha rtol 1e-4 / atol 1e-5, depth rtol 1e-4 / atol 1e-4 where alpha >
0.05). H = 50 is not divisible by the 8 bands. The JAX side takes its jnp
path; the port's "tiled" runs its kernels' plain twins on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.parallel.tiled import render_tiled as jrender_tiled
from tpu_gaussians_torch.cli import render as trender_cli
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.core.types import gaussians_from_numpy
from tpu_gaussians_torch.io.npz import save_gaussians_npz
from tpu_gaussians_torch.ops.dispatch import render, render_accum
from tpu_gaussians_torch.parallel.tiled import render_tiled

from .utils import random_scene

W, H = 64, 50
BANDS = 8


def both(n, seed, use_sh=False):
    g = random_scene(n, seed=seed, use_sh=use_sh)
    arrays = {f.name: np.asarray(getattr(g, f.name))
              for f in dataclasses.fields(g)
              if getattr(g, f.name) is not None}
    return g, gaussians_from_numpy(arrays, device="cpu")


def assert_close(a, b, rtol, atol):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("mode,impl", [
    ("accum", "torch"), ("accum", "tiled"), ("sorted", "tiled")])
def test_tiled_matches_full_and_jax(mode, impl):
    jg, tg = both(120, seed=2)
    cfg = TConfig(width=W, height=H, impl=impl, mode=mode, return_aux=True,
                  chunk_size=32)
    cam = tcam.orbit_cameras(4, W, H, device="cpu")[1]
    full = render(tg, cam, cfg)
    tiled = render_tiled(tg, cam, cfg, n_devices=BANDS)
    assert_close(tiled, full, 2e-5, 2e-5)
    # One device named for every band renders them in turn: the same.
    assert_close(render_tiled(tg, cam, cfg, devices=["cpu"] * BANDS), full,
                 0, 0)

    j_out = jrender_tiled(jg, jcam.orbit_cameras(4, W, H)[1], JConfig(
        width=W, height=H, impl="jnp", mode=mode, return_aux=True,
        chunk_size=32), n_devices=BANDS)
    ti, ta, td = (t.numpy() for t in tiled)
    ji, ja, jd = (np.asarray(x) for x in j_out)
    np.testing.assert_allclose(ti, ji, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-5)
    covered = ja > 0.05
    assert covered.any()
    np.testing.assert_allclose(td[covered], jd[covered], rtol=1e-4,
                               atol=1e-4)


def test_row_window_is_exact():
    """A row-window render (row0 + proj_height) equals the corresponding
    rows of the full-frame render, including aux outputs."""
    _, tg = both(60, seed=5, use_sh=True)
    cam = tcam.orbit_cameras(4, W, H, device="cpu")[2]
    cfg = TConfig(width=W, height=H, impl="torch", return_aux=True,
                  chunk_size=16)
    full = render(tg, cam, cfg)
    win = render_accum(tg, cam.view, cam.proj,
                       cfg.replace(height=10, proj_height=H), row0=20.0)
    assert_close(win, [t[20:30] for t in full], 2e-5, 2e-5)
    # image only without return_aux
    image = render_tiled(tg, cam, cfg.replace(return_aux=False), n_devices=3)
    assert_close([image], [full[0]], 2e-5, 2e-5)


def test_tiled_rejects_batched_camera():
    _, tg = both(10, seed=0)
    cams = tcam.orbit_cameras(2, W, H, device="cpu")
    with pytest.raises(ValueError, match="unbatched"):
        render_tiled(tg, cams, TConfig(width=W, height=H, impl="torch"),
                     n_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            render_tiled(tg, cams[0], TConfig(width=W, height=H),
                         devices=["cuda"])


def test_render_cli_shard_bands(tmp_path):
    """cli.render --shard_bands 3 writes the frames the whole-frame render
    writes, to within one 8-bit step."""
    _, tg = both(80, seed=3)
    npz = tmp_path / "scene.npz"
    save_gaussians_npz(npz, tg)
    frames = {}
    for bands in (0, 3):
        out = tmp_path / f"bands{bands}"
        trender_cli.main([str(npz), "--out_dir", str(out), "--width", str(W),
                          "--height", str(H), "--num_views", "2", "--device",
                          "cpu", "--shard_bands", str(bands)])
        frames[bands] = [np.asarray(Image.open(out / f"view_{i:03d}.png"),
                                    np.int16) for i in range(2)]
    for a, b in zip(frames[0], frames[3]):
        assert a.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1

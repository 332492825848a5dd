"""Port parity, the whole slice: `tpu_gaussians_torch.ops.dispatch.render`
against `tpu_gaussians.ops.dispatch.render` on identical scenes (CPU).

  impl "tiled" (binner + compositing kernel's plain twin) vs "pallas"
  (binner + TPU kernel in interpret mode), and "torch" vs "jnp".

Tolerances are those of the JAX suite's own pallas-vs-jnp sorted test
(tests/test_sorted_pallas.py): image and alpha rtol 1e-4 / atol 1e-5,
depth on covered pixels (alpha > 0.05) rtol 1e-4 / atol 1e-4 (the
z/(alpha + 1e-6) resolve amplifies float noise where alpha is tiny)."""

import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.core.types import make_gaussians
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.core.types import gaussians_from_numpy
from tpu_gaussians_torch.ops import dispatch as tdispatch

W, H = 256, 48
INTERACTIVE = dict(sorted_pair_k=8, sorted_exit_t=1e-3,
                   sorted_band_capacity=1024)


def scene(n, seed, sh=False, quats=False):
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (n,)).astype(np.float32))
    if sh:
        c = rng.normal(0.0, 0.15, (n, 4, 3)).astype(np.float32)
        c[:, 0] = rng.uniform(0.0, 1.0, (n, 3))
        arr["sh"] = c
    else:
        arr["colors"] = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if quats:
        arr["quats"] = rng.normal(size=(n, 4)).astype(np.float32)
    return make_gaussians(**arr), gaussians_from_numpy(arr, device="cpu")


def assert_frames_match(t_out, j_out):
    ti, ta, td = (x.numpy() for x in t_out)
    ji, ja, jd = (np.asarray(x) for x in j_out)
    np.testing.assert_allclose(ti, ji, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-5)
    covered = ja > 0.05
    assert covered.any()
    np.testing.assert_allclose(td[covered], jd[covered], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("knobs", [{}, INTERACTIVE],
                         ids=["default", "interactive"])
def test_tiled_matches_pallas(knobs):
    jg, tg = scene(1000, 0)
    kw = dict(width=W, height=H, mode="sorted", return_aux=True,
              background=(0.02, 0.05, 0.1), **knobs)
    j_out = jdispatch.render(jg, jcam.orbit_cameras(4, W, H)[1],
                             JConfig(impl="pallas", **kw))
    with torch.no_grad():
        t_out = tdispatch.render(
            tg, tcam.orbit_cameras(4, W, H, device="cpu")[1],
            TConfig(impl="tiled", **kw))
    assert_frames_match(t_out, j_out)


def test_tiled_ewa_batched_cameras_match_pallas():
    jg, tg = scene(200, 1, sh=True, quats=True)
    kw = dict(width=128, height=32, mode="sorted", return_aux=True,
              footprint="ewa", sorted_band_capacity=512)
    j_out = jdispatch.render(jg, jcam.orbit_cameras(2, 128, 32),
                             JConfig(impl="pallas", **kw))
    with torch.no_grad():
        t_out = tdispatch.render(
            tg, tcam.orbit_cameras(2, 128, 32, device="cpu"),
            TConfig(impl="tiled", **kw))
    assert t_out[0].shape == (2, 32, 128, 3)
    assert_frames_match(t_out, j_out)


@pytest.mark.parametrize("footprint,sh", [("axis", True), ("ewa", False)])
def test_torch_matches_jnp(footprint, sh):
    jg, tg = scene(400, 2, sh=sh, quats=footprint == "ewa")
    kw = dict(width=96, height=64, mode="sorted", return_aux=True,
              footprint=footprint, background=(0.1, 0.1, 0.1),
              chunk_size=32)
    j_out = jdispatch.render(jg, jcam.orbit_cameras(4, 96, 64)[2],
                             JConfig(impl="jnp", **kw))
    t_out = tdispatch.render(tg, tcam.orbit_cameras(4, 96, 64,
                                                    device="cpu")[2],
                             TConfig(impl="torch", **kw))
    assert_frames_match(tuple(x.detach() for x in t_out), j_out)


def test_return_stats_and_row_window_match_pallas():
    jg, tg = scene(600, 3)
    kw = dict(width=128, height=32, mode="sorted", proj_height=64,
              sorted_band_capacity=512, sorted_pair_k=8)
    jc = jcam.orbit_cameras(4, 128, 64)[0]
    tc = tcam.orbit_cameras(4, 128, 64, device="cpu")[0]
    j_out = jdispatch.render_sorted(jg, jc.view, jc.proj,
                                    JConfig(impl="pallas", **kw), row0=16.0,
                                    return_stats=True)
    with torch.no_grad():
        t_out = tdispatch.render_sorted(tg, tc.view, tc.proj,
                                        TConfig(impl="tiled", **kw),
                                        row0=16.0, return_stats=True)
    assert_frames_match(t_out[:3], j_out[:3])
    assert {k: int(v) for k, v in t_out[3].items()} == {
        k: int(v) for k, v in j_out[3].items()}
    *_, zeros = tdispatch.render_sorted(tg, tc.view, tc.proj,
                                        TConfig(impl="torch", **kw),
                                        return_stats=True)
    assert all(int(v) == 0 for v in zeros.values())


def test_tiled_path_refuses_grad_and_accum_mode():
    _, tg = scene(50, 4)
    tc = tcam.orbit_cameras(1, 64, 32, device="cpu")
    cfg = TConfig(width=64, height=32, mode="sorted", impl="tiled")
    g = tg.replace(means=tg.means.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="training slice"):
        tdispatch.render(g, tc, cfg)
    img = tdispatch.render(g, tc, cfg.replace(impl="torch"))
    img.sum().backward()                     # the plain path has autograd
    assert torch.isfinite(g.means.grad).all()
    with pytest.raises(NotImplementedError, match="slice 2"):
        tdispatch.render(tg, tc, cfg.replace(mode="accum"))

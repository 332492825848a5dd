"""Port parity, per-gaussian stage: types, camera math, npz I/O,
projection, SH colors, conics and prepare_splats of `tpu_gaussians_torch`
against `tpu_gaussians` on identical numpy inputs (CPU).

Both sides evaluate the same f32 formulas; only summation order and libm
ulps differ, hence rtol 1e-5 / atol 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core import types as jtypes
from tpu_gaussians.io import npz as jnpz
from tpu_gaussians.ops import common as jcommon
from tpu_gaussians.ops import ewa as jewa
from tpu_gaussians.ops import projection as jproj
from tpu_gaussians.ops import sh as jsh
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core import types as ttypes
from tpu_gaussians_torch.io import npz as tnpz
from tpu_gaussians_torch.ops import common as tcommon
from tpu_gaussians_torch.ops import ewa as tewa
from tpu_gaussians_torch.ops import projection as tproj
from tpu_gaussians_torch.ops import sh as tsh

RTOL, ATOL = 1e-5, 1e-6
W, H = 96, 64


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def scene_arrays(n, seed, sh_k=0, quats=False, alive=False):
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (n,)).astype(np.float32))
    if sh_k:
        sh = rng.normal(0.0, 0.15, (n, sh_k, 3)).astype(np.float32)
        sh[:, 0] = rng.uniform(0.0, 1.0, (n, 3))
        arr["sh"] = sh
    else:
        arr["colors"] = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if quats:
        arr["quats"] = rng.normal(size=(n, 4)).astype(np.float32)
    if alive:
        arr["alive"] = (rng.uniform(size=n) < 0.7).astype(np.float32)
    return arr


def both(arr):
    return (jtypes.make_gaussians(**arr),
            ttypes.gaussians_from_numpy(arr, device="cpu"))


def cameras(views=4):
    return (jcam.orbit_cameras(views, W, H),
            tcam.orbit_cameras(views, W, H, device="cpu"))


def test_render_config_has_same_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(jtypes.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttypes.RenderConfig)}
    assert jf == tf
    with pytest.raises(ValueError):
        ttypes.RenderConfig(impl="pallas")
    assert ttypes.RenderConfig(impl="tiled").impl == "tiled"


def test_gaussians_fields_and_validation():
    jf = [f.name for f in dataclasses.fields(jtypes.Gaussians)]
    assert jf == [f.name for f in dataclasses.fields(ttypes.Gaussians)]
    arr = scene_arrays(10, 0, alive=True)
    g = ttypes.gaussians_from_numpy(arr, device="cpu")
    for k, v in arr.items():
        np.testing.assert_array_equal(getattr(g, k).numpy(), v)
    assert int(g.num_alive()) == int(arr["alive"].sum())
    with pytest.raises(ValueError):
        ttypes.make_gaussians(arr["means"], arr["scales"], arr["opacities"],
                              device="cpu")           # neither colors nor sh
    with pytest.raises(ValueError):
        ttypes.make_gaussians(arr["means"], arr["scales"][:5],
                              arr["opacities"], colors=arr["colors"],
                              device="cpu")
    with pytest.raises(KeyError):
        ttypes.gaussians_from_numpy({**arr, "bogus": arr["means"]}, "cpu")
    with pytest.raises(ValueError):
        ttypes.validate_camera(ttypes.Camera(view=torch.eye(4),
                                             proj=torch.eye(3)))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        ttypes.resolve_device("cuda")
    arr = scene_arrays(4, 0)
    with pytest.raises(RuntimeError):
        ttypes.gaussians_from_numpy(arr, device="cuda")
    with pytest.raises(RuntimeError):
        tcam.perspective(60.0, 1.5, 0.01, 100.0)


@pytest.mark.parametrize("fovy,aspect", [(60.0, 1.5), (45.0, 0.75)])
def test_perspective_and_look_at(fovy, aspect):
    close(tcam.perspective(fovy, aspect, 0.01, 100.0, device="cpu"),
          jcam.perspective(fovy, aspect, 0.01, 100.0))
    eye, target, up = [0.3, 1.1, 2.4], [0.1, -0.2, 0.05], [0.0, 1.0, 0.0]
    close(tcam.look_at(eye, target, up, device="cpu"),
          jcam.look_at(eye, target, up))


def test_orbit_cameras_position_and_npz(tmp_path):
    jc, tc = cameras(5)
    close(tc.view, jc.view)
    close(tc.proj, jc.proj)
    close(tcam.camera_position_from_view(tc.view),
          jcam.camera_position_from_view(jc.view))
    # npz written by the JAX package loads in the port, and vice versa
    jcam.save_cameras_npz(tmp_path / "j.npz", jc)
    loaded = tcam.load_cameras_npz(tmp_path / "j.npz", expected_views=5,
                                   device="cpu")
    close(loaded.view, jc.view)
    tcam.save_cameras_npz(tmp_path / "t.npz", tc[2])
    back = jcam.load_cameras_npz(tmp_path / "t.npz")
    close(tc.view[2:3], back.view)
    with pytest.raises(ValueError):
        tcam.load_cameras_npz(tmp_path / "j.npz", expected_views=4,
                              device="cpu")


@pytest.mark.parametrize("sh_k", [0, 4, 16])
def test_npz_round_trip_between_packages(tmp_path, sh_k):
    arr = scene_arrays(40, 1, sh_k=sh_k, quats=True, alive=True)
    jg, tg = both(arr)
    jnpz.save_gaussians_npz(tmp_path / "j.npz", jg)
    tnpz.save_gaussians_npz(tmp_path / "t.npz", tg)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL)
    tl = tnpz.load_gaussians_npz(tmp_path / "j.npz", device="cpu")
    jl = jnpz.load_gaussians_npz(tmp_path / "j.npz")
    for f in ("means", "scales", "opacities", "colors", "sh", "quats"):
        if getattr(jl, f) is None:
            assert getattr(tl, f) is None
        else:
            close(getattr(tl, f), getattr(jl, f))


@pytest.mark.parametrize("view_index", [0, 3])
def test_project_and_camera_z(view_index):
    arr = scene_arrays(300, 2)
    jc, tc = cameras()
    jv, tv = jc[view_index], tc[view_index]
    js = jproj.project(jnp.asarray(arr["means"]), jv.view, jv.proj, W, H,
                       jnp.asarray(arr["scales"]))
    ts = tproj.project(torch.from_numpy(arr["means"]), tv.view, tv.proj,
                       W, H, torch.from_numpy(arr["scales"]))
    for name in js._fields:
        close(getattr(ts, name), getattr(js, name))
    close(tproj.camera_z(torch.from_numpy(arr["means"]), tv.view),
          jproj.camera_z(jnp.asarray(arr["means"]), jv.view))


@pytest.mark.parametrize("sh_k", [0, 4, 9, 16])
def test_eval_colors(sh_k):
    arr = scene_arrays(200, 3, sh_k=sh_k)
    jc, tc = cameras()
    c = arr["sh"] if sh_k else arr["colors"]
    close(tsh.eval_colors(torch.from_numpy(c),
                          torch.from_numpy(arr["means"]), tc.view[1]),
          jsh.eval_colors(jnp.asarray(c), jnp.asarray(arr["means"]),
                          jc.view[1]))
    with pytest.raises(ValueError):
        tsh.eval_colors(torch.zeros(3, 5, 3), torch.zeros(3, 3), tc.view[1])


def test_conics():
    arr = scene_arrays(200, 4, quats=True)
    jc, tc = cameras()
    sx = np.random.default_rng(5).uniform(1.0, 9.0, (2, 200)).astype(
        np.float32)
    jcon = jewa.axis_aligned_conic(jnp.asarray(sx[0]), jnp.asarray(sx[1]))
    tcon = tewa.axis_aligned_conic(torch.from_numpy(sx[0]),
                                   torch.from_numpy(sx[1]))
    for name in jcon._fields:
        close(getattr(tcon, name), getattr(jcon, name))
    close(tewa.quat_to_rot(torch.from_numpy(arr["quats"])),
          jewa.quat_to_rot(jnp.asarray(arr["quats"])))
    jcon = jewa.ewa_conic(*(jnp.asarray(arr[k])
                            for k in ("means", "scales", "quats")),
                          jc.view[2], jc.proj[2], W, H)
    tcon = tewa.ewa_conic(*(torch.from_numpy(arr[k])
                            for k in ("means", "scales", "quats")),
                          tc.view[2], tc.proj[2], W, H)
    for name in jcon._fields:
        close(getattr(tcon, name), getattr(jcon, name))


@pytest.mark.parametrize("footprint,sh_k,quats", [
    ("axis", 0, False), ("axis", 4, False), ("ewa", 9, True),
    ("ewa", 0, False)])
def test_prepare_splats(footprint, sh_k, quats):
    jg, tg = both(scene_arrays(300, 6, sh_k=sh_k, quats=quats, alive=True))
    jc, tc = cameras()
    js = jcommon.prepare_splats(jg, jc.view[1], jc.proj[1], W, H,
                                footprint=footprint)
    ts = tcommon.prepare_splats(tg, tc.view[1], tc.proj[1], W, H,
                                footprint=footprint)
    for name in js._fields:
        close(getattr(ts, name), getattr(js, name))
    jx, jy = jcommon.pixel_grid(H, W)
    tx, ty = tcommon.pixel_grid(H, W, "cpu")
    close(tx, jx)
    close(ty, jy)

"""Port parity, COLMAP import: `tpu_gaussians_torch.io.colmap`,
`models.gaussian_model.init_params_from_points` and `cli.import_colmap`
against `tpu_gaussians`' on the same COLMAP models (tests/test_colmap.py's
`_make_model`, binary and text) and point clouds (CPU).

The readers and the view/proj conversion give equal arrays (pure numpy in
both). `init_params_from_points` is bitwise equal where it draws nothing
(P <= min(capacity, 4096)), and bitwise equal given JAX's subsample and
anchor indices where it draws. The import CLI's three outputs are equal
(its init_points.npz holds activated values: each package's softplus and
sigmoid give the same float32 there). The mirrors of tests/test_colmap.py
keep its tolerances."""

import jax
import numpy as np
import pytest
import torch

from tpu_gaussians.cli import import_colmap as jimport
from tpu_gaussians.io import colmap as jcolmap
from tpu_gaussians.models import gaussian_model as jmodel
from tpu_gaussians_torch.cli import import_colmap as timport
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.io import colmap as tcolmap
from tpu_gaussians_torch.models import gaussian_model as tmodel

from .test_colmap import _make_model


def cloud(p, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(p, 3)).astype(np.float32),
            rng.uniform(size=(p, 3)).astype(np.float32))


def raw_arrays(raw):
    """RawParams leaves (either package's) as numpy arrays."""
    return {f: np.asarray(getattr(raw, f)) for f in tmodel.LEAVES
            if getattr(raw, f) is not None}


@pytest.mark.parametrize("binary", [True, False])
def test_readers_match_jax(tmp_path, binary):
    _make_model(tmp_path, binary)
    j_cams, j_images, j_xyz, j_rgb = jcolmap.read_model(tmp_path)
    t_cams, t_images, t_xyz, t_rgb = tcolmap.read_model(tmp_path)
    assert list(t_cams) == list(j_cams)
    for cid in j_cams:
        jc, tc = j_cams[cid], t_cams[cid]
        assert (tc.camera_id, tc.model, tc.width, tc.height) == \
            (jc.camera_id, jc.model, jc.width, jc.height)
        np.testing.assert_array_equal(tc.params, jc.params)
    assert len(t_images) == len(j_images)
    for ti, ji in zip(t_images, j_images):
        assert (ti.image_id, ti.camera_id, ti.name) == \
            (ji.image_id, ji.camera_id, ji.name)
        np.testing.assert_array_equal(ti.qvec, ji.qvec)
        np.testing.assert_array_equal(ti.tvec, ji.tvec)
    np.testing.assert_array_equal(t_xyz, j_xyz)
    np.testing.assert_array_equal(t_rgb, j_rgb)
    for t, j in zip(tcolmap.colmap_to_view_proj(t_cams, t_images),
                    jcolmap.colmap_to_view_proj(j_cams, j_images)):
        np.testing.assert_array_equal(t, j)


def test_qvec_to_rotmat_matches_jax():
    q = np.random.default_rng(0).normal(size=(8, 4))
    for qi in q:
        np.testing.assert_array_equal(tcolmap.qvec_to_rotmat(qi),
                                      jcolmap.qvec_to_rotmat(qi))
    np.testing.assert_allclose(tcolmap.qvec_to_rotmat(np.array(
        [1.0, 0, 0, 0])), np.eye(3), atol=1e-12)


@pytest.mark.parametrize("binary", [True, False])
def test_roundtrip_and_convention(tmp_path, binary):
    rig, pts, rgb = _make_model(tmp_path, binary)
    cams, images, p_xyz, p_rgb = tcolmap.read_model(tmp_path)
    assert [im.name for im in images] == ["img_00.png", "img_01.png"]
    np.testing.assert_allclose(p_xyz, pts, atol=1e-6)
    np.testing.assert_allclose(p_rgb, rgb, atol=1e-2)
    view, proj, (w, h) = tcolmap.colmap_to_view_proj(cams, images)
    assert (w, h) == (64, 48)
    np.testing.assert_allclose(view, np.asarray(rig.view), atol=1e-5)
    want = tcam.perspective(60.0, 64 / 48, 0.01, 100.0, device="cpu")
    np.testing.assert_allclose(proj[0], want.numpy(), atol=1e-4)


INIT_CASES = {
    "rgb": dict(),
    "sh1": dict(use_sh=True),
    "sh3_quats": dict(use_sh=True, sh_degree=3, use_quats=True),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_from_points_bitwise_without_draws(case):
    pts, rgb = cloud(50, 0)
    kw = INIT_CASES[case]
    j = jmodel.init_params_from_points(jax.random.PRNGKey(0), pts, rgb,
                                       capacity=64, **kw)
    t = tmodel.init_params_from_points(torch.Generator().manual_seed(0),
                                       pts, rgb, capacity=64, device="cpu",
                                       **kw)
    ja, ta = raw_arrays(j), raw_arrays(t)
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


@pytest.mark.parametrize("p,capacity", [(50, 20), (5000, 4500)],
                         ids=["subsample", "subsample_and_anchors"])
def test_init_from_points_with_jax_draws(p, capacity):
    """P > capacity subsamples; past 4096 points the NN anchors are drawn
    too: JAX's draws, passed in, give JAX's parameters bit for bit."""
    pts, rgb = cloud(p, 1)
    key = jax.random.PRNGKey(7)
    k_sub, k_anchor = jax.random.split(key)
    sel = np.asarray(jax.random.choice(k_sub, p, (capacity,), replace=False))
    anchors = (np.asarray(jax.random.choice(k_anchor, capacity, (4096,),
                                            replace=False))
               if capacity > 4096 else None)
    j = jmodel.init_params_from_points(key, pts, rgb, capacity=capacity,
                                       use_sh=True)
    t = tmodel.init_params_from_points(None, pts, rgb, capacity=capacity,
                                       use_sh=True, device="cpu",
                                       draws=(sel, anchors))
    for k, v in raw_arrays(j).items():
        np.testing.assert_array_equal(raw_arrays(t)[k], v, err_msg=k)
    # the port's own draws: a uniform subsample without repeats
    own = tmodel.init_params_from_points(torch.Generator().manual_seed(3),
                                         pts, rgb, capacity=capacity,
                                         device="cpu")
    kept = own.means.numpy()
    assert int(own.alive.sum()) == capacity
    assert len(np.unique(kept, axis=0)) == capacity
    assert np.isin(kept.view([("", kept.dtype)] * 3),
                   pts.view([("", pts.dtype)] * 3)).all()


def test_init_from_points():
    pts, rgb = cloud(50, 0)
    gen = torch.Generator().manual_seed(0)
    raw = tmodel.init_params_from_points(gen, pts, rgb, capacity=64,
                                         device="cpu")
    g = tmodel.activate(raw)
    assert int(raw.alive_mask().sum()) == 50
    np.testing.assert_allclose(g.means[:50], pts, atol=1e-6)
    np.testing.assert_allclose(g.colors[:50], rgb, atol=1e-3)
    scales = g.scales[:50].numpy()
    assert np.all(scales > 0) and np.all(scales[:, 0] == scales[:, 1])
    raw_sh = tmodel.init_params_from_points(gen, pts, rgb, capacity=64,
                                            use_sh=True, device="cpu")
    np.testing.assert_allclose(tmodel.activate(raw_sh).sh[:50, 0, :], rgb,
                               atol=1e-3)
    raw_sub = tmodel.init_params_from_points(gen, pts, rgb, capacity=20,
                                             device="cpu")
    assert int(raw_sub.alive_mask().sum()) == 20
    with pytest.raises(ValueError, match="empty"):
        tmodel.init_params_from_points(gen, pts[:0], rgb[:0], 8,
                                       device="cpu")


def test_raw_from_gaussians_roundtrip():
    pts = np.random.default_rng(3).normal(size=(30, 3)).astype(np.float32)
    rgb = np.random.default_rng(4).uniform(0.1, 0.9, size=(30, 3)
                                           ).astype(np.float32)
    raw = tmodel.init_params_from_points(torch.Generator().manual_seed(2),
                                         pts, rgb, capacity=30, device="cpu")
    g = tmodel.activate(raw)
    g2 = tmodel.activate(tmodel.raw_from_gaussians(g, capacity=40))
    np.testing.assert_allclose(g2.means[:30], g.means[:30], atol=1e-6)
    np.testing.assert_allclose(g2.scales[:30], g.scales[:30], rtol=1e-4)
    np.testing.assert_allclose(g2.opacities[:30], g.opacities[:30],
                               rtol=1e-4)
    assert int(g2.alive_mask().sum()) == 30


def test_import_cli_matches_jax_and_feeds_fit(tmp_path, capsys):
    """cli.import_colmap's three outputs equal JAX's, its printout names
    the port's fit CLI, and its init_points.npz warm-starts the port's fit
    (3 iterations on the CPU)."""
    model = tmp_path / "sparse0"
    model.mkdir()
    _make_model(model, binary=True)
    argv = ["--colmap_dir", str(model), "--init_out", "--max_points", "5"]
    timport.main(argv + ["--out_dir", str(tmp_path / "t")])
    printed = capsys.readouterr().out
    assert "python -m tpu_gaussians_torch.cli.fit" in printed
    jimport.main(argv + ["--out_dir", str(tmp_path / "j")])
    t_cams, j_cams = (np.load(tmp_path / d / "cameras.npz") for d in "tj")
    for k in ("view", "proj"):
        np.testing.assert_array_equal(t_cams[k], j_cams[k])
    assert (tmp_path / "t" / "image_order.txt").read_text() == \
        (tmp_path / "j" / "image_order.txt").read_text()
    t_init, j_init = (np.load(tmp_path / d / "init_points.npz")
                      for d in "tj")
    assert sorted(t_init.files) == sorted(j_init.files)
    for k in j_init.files:
        np.testing.assert_array_equal(t_init[k], j_init[k], err_msg=k)

    from tpu_gaussians_torch.fit.trainer import fit
    from tpu_gaussians_torch.utils.config import FitConfig

    loaded = tcam.load_cameras_npz(tmp_path / "t" / "cameras.npz", 2,
                                   device="cpu")
    targets = np.full((2, 48, 64, 3), 0.3, np.float32)
    config = FitConfig(iters=3, width=64, height=48, num_gaussians=5,
                       max_gaussians=8, use_sh=True, silhouette_weight=0.0,
                       densify_interval=0, prune_interval=0, log_every=1000,
                       init_npz=str(tmp_path / "t" / "init_points.npz"))
    assert len(fit(config, targets, loaded, device="cpu").loss_log) == 3

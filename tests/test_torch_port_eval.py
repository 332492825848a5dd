"""Port parity, evaluation: `tpu_gaussians_torch.cli.eval` against
`tpu_gaussians.cli.eval` on the same fitted model (npz or ply), targets
and cameras (CPU; the JAX side through its jnp renderer).

The reports agree view by view within |dPSNR| <= 0.01 dB, |dSSIM| <=
1e-4 and |dL1| <= 1e-5 (the two renderers and SSIM filters round
differently in float32), and carry the same keys, targets, mode,
footprint and size. The mirror of tests/test_ssim_eval.py::test_eval_cli
keeps its bounds (PSNR > 40 dB, SSIM > 0.98 on a self-eval)."""

import json

import numpy as np
import pytest
import torch

from tpu_gaussians.cli import eval as jeval
from tpu_gaussians_torch.cli import eval as teval
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig, gaussians_from_numpy
from tpu_gaussians_torch.io.image import save_image_png
from tpu_gaussians_torch.io.npz import save_gaussians_npz
from tpu_gaussians_torch.io.ply import save_gaussians_ply
from tpu_gaussians_torch.ops.dispatch import render

W, H = 48, 32
TOL = {"psnr": 0.01, "ssim": 1e-4, "l1": 1e-5}


def model(n, seed, sh=False, quats=False):
    rng = np.random.default_rng(seed)
    arr = dict(means=rng.uniform(-0.6, 0.6, (n, 3)),
               scales=rng.uniform(0.02, 0.25, (n, 3)),
               opacities=rng.uniform(0.05, 0.95, (n,)))
    if sh:
        arr["sh"] = np.concatenate([rng.uniform(0, 1, (n, 1, 3)),
                                    rng.normal(0, 0.15, (n, 3, 3))], axis=1)
    else:
        arr["colors"] = rng.uniform(0.0, 1.0, (n, 3))
    if quats:
        arr["quats"] = rng.normal(size=(n, 4))
    return gaussians_from_numpy({k: v.astype(np.float32)
                                 for k, v in arr.items()}, device="cpu")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A fitted-model stand-in (SH, 25 gaussians), its ply, 3 noisy target
    views of it and a camera npz."""
    d = tmp_path_factory.mktemp("eval")
    g = model(25, 3, sh=True)
    cams = tcam.orbit_cameras(3, W, H, device="cpu")
    with torch.no_grad():
        imgs = render(g, cams, RenderConfig(width=W, height=H,
                                            impl="torch")).numpy()
    noise = np.random.default_rng(4).normal(0, 0.05, imgs.shape)
    (d / "targets").mkdir()
    for i in range(3):
        save_image_png(d / "targets" / f"v{i:02d}.png",
                       np.clip(imgs[i] + noise[i], 0, 1))
    save_gaussians_npz(d / "model.npz", g)
    save_gaussians_ply(d / "model.ply", g)
    tcam.save_cameras_npz(d / "cams.npz", cams)
    return d


CASES = {
    "npz_accum_torch": ("model.npz", "accum", "torch"),
    "npz_accum_tiled": ("model.npz", "accum", "auto"),
    "npz_sorted_tiled": ("model.npz", "sorted", "auto"),
    "ply_accum_tiled": ("model.ply", "accum", "auto"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_report_matches_jax(scene, tmp_path, case):
    name, mode, impl = CASES[case]
    common = [str(scene / name), "--targets_dir", str(scene / "targets"),
              "--camera_npz", str(scene / "cams.npz"), "--width", str(W),
              "--height", str(H), "--mode", mode]
    jeval.main(common + ["--impl", "jnp", "--out", str(tmp_path / "j.json")])
    teval.main(common + ["--impl", impl, "--device", "cpu", "--out",
                         str(tmp_path / "t.json")])
    j, t = (json.loads((tmp_path / f).read_text())
            for f in ("j.json", "t.json"))
    assert set(t) == set(j)
    for k in ("num_gaussians", "mode", "footprint", "size"):
        assert t[k] == j[k], k
    assert [v["target"] for v in t["views"]] == \
        [v["target"] for v in j["views"]]
    for tv, jv in zip(t["views"] + [t["mean"]], j["views"] + [j["mean"]]):
        for k, tol in TOL.items():
            assert abs(tv[k] - jv[k]) <= tol, (k, tv[k], jv[k])


def test_eval_flags_match_jax():
    def options(ap):
        return {s: a.default for a in ap._actions for s in a.option_strings}

    j, t = options(jeval.build_parser()), options(teval.build_parser())
    assert set(t) == set(j) | {"--device"} and t["--device"] == "cuda"
    assert {k: v for k, v in t.items() if k != "--device"} == j
    impl = next(a for a in teval.build_parser()._actions
                if "--impl" in a.option_strings)
    assert impl.choices == ["auto", "torch", "tiled"]


def test_eval_footprint_auto_follows_quaternions(tmp_path, capsys):
    """--footprint auto evaluates a model with quaternions under ewa, one
    without under axis."""
    cams = tcam.orbit_cameras(2, W, H, device="cpu")
    (tmp_path / "t").mkdir()
    for i in range(2):
        save_image_png(tmp_path / "t" / f"v{i}.png",
                       np.full((H, W, 3), 0.5, np.float32))
    tcam.save_cameras_npz(tmp_path / "cams.npz", cams)
    for quats, want in ((True, "ewa"), (False, "axis")):
        save_gaussians_npz(tmp_path / "m.npz", model(10, 5, quats=quats))
        teval.main([str(tmp_path / "m.npz"), "--targets_dir",
                    str(tmp_path / "t"), "--camera_npz",
                    str(tmp_path / "cams.npz"), "--width", str(W),
                    "--height", str(H), "--device", "cpu", "--out",
                    str(tmp_path / "r.json")])
        assert json.loads((tmp_path / "r.json").read_text())[
            "footprint"] == want


def test_eval_cli(tmp_path):
    """tests/test_ssim_eval.py::test_eval_cli: a self-eval against the
    model's own renders is near-lossless (PNG quantization)."""
    g = model(25, 3)
    cams = tcam.orbit_cameras(3, W, H, device="cpu")
    with torch.no_grad():
        imgs = render(g, cams, RenderConfig(width=W, height=H, impl="torch",
                                            chunk_size=32)).numpy()
    tdir = tmp_path / "targets"
    tdir.mkdir()
    for i in range(3):
        save_image_png(tdir / f"v{i:02d}.png", imgs[i])
    save_gaussians_npz(tmp_path / "model.npz", g)
    out = tmp_path / "eval.json"
    teval.main([str(tmp_path / "model.npz"), "--targets_dir", str(tdir),
                "--width", str(W), "--height", str(H), "--impl", "torch",
                "--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    assert len(report["views"]) == 3
    assert report["mean"]["psnr"] > 40.0
    assert report["mean"]["ssim"] > 0.98

"""Port parity, PLY interop: `tpu_gaussians_torch.io.ply` and
`cli.convert` against `tpu_gaussians`' on identical numpy models (CPU).

A ply written by the port is the one JAX writes, byte for byte (RGB,
SH-1, SH-3 and quaternion models), and each package loads the other's
file equal (exactly: both parse with the same numpy arithmetic). The
mirrors of tests/test_ply.py keep its tolerances: means rtol 1e-5 /
atol 1e-6, scales and opacities rtol 1e-4, colors and SH rtol 1e-3 /
atol 1e-5, quaternions rtol 1e-4 / atol 1e-5, the render through the
ply atol 1e-4."""

import numpy as np
import pytest

from tpu_gaussians.cli import convert as jconvert
from tpu_gaussians.core.types import make_gaussians as jmake
from tpu_gaussians.io import ply as jply
from tpu_gaussians_torch.cli import convert as tconvert
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig, gaussians_from_numpy
from tpu_gaussians_torch.io import ply as tply
from tpu_gaussians_torch.io.npz import load_gaussians_npz, save_gaussians_npz
from tpu_gaussians_torch.ops.dispatch import render

FIELDS = ("means", "scales", "opacities", "colors", "sh", "alive", "quats")


def scene(n, seed, bands=0, quats=False, alive_frac=None):
    """Model arrays as numpy (tests/utils.random_scene's distributions):
    RGB colors, or SH with `bands` coefficient rows."""
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)),
        scales=rng.uniform(0.02, 0.25, (n, 3)),
        opacities=rng.uniform(0.05, 0.95, (n,)))
    if bands:
        sh = np.zeros((n, bands, 3))
        sh[:, 0] = rng.uniform(0.0, 1.0, (n, 3))
        sh[:, 1:] = rng.normal(0.0, 0.15, (n, bands - 1, 3))
        arr["sh"] = sh
    else:
        arr["colors"] = rng.uniform(0.0, 1.0, (n, 3))
    if quats:
        arr["quats"] = rng.normal(size=(n, 4))
    if alive_frac is not None:
        arr["alive"] = (rng.uniform(size=n) < alive_frac).astype(np.float64)
    return {k: v.astype(np.float32) for k, v in arr.items()}


def both(arr):
    return jmake(**arr), gaussians_from_numpy(arr, device="cpu")


def fields(g):
    """A model's set fields as numpy arrays (either package's)."""
    return {f: np.asarray(getattr(g, f)) for f in FIELDS
            if getattr(g, f) is not None}


MODELS = {
    "rgb": dict(n=30, seed=1),
    "sh1": dict(n=20, seed=3, bands=4),
    "sh3": dict(n=20, seed=4, bands=16),
    "quats_dead_rows": dict(n=25, seed=5, bands=4, quats=True,
                            alive_frac=0.7),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_ply_equals_jax_ply_byte_for_byte(tmp_path, name):
    jg, tg = both(scene(**MODELS[name]))
    jply.save_gaussians_ply(tmp_path / "j.ply", jg)
    tply.save_gaussians_ply(tmp_path / "t.ply", tg)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_each_package_loads_the_others_ply_equal(tmp_path, name):
    jg, tg = both(scene(**MODELS[name]))
    jply.save_gaussians_ply(tmp_path / "j.ply", jg)
    tply.save_gaussians_ply(tmp_path / "t.ply", tg)
    for path in ("j.ply", "t.ply"):
        j = fields(jply.load_gaussians_ply(tmp_path / path))
        t = fields(tply.load_gaussians_ply(tmp_path / path, device="cpu"))
        assert set(t) - {"alive"} == set(j) - {"alive"}
        for k in set(j) - {"alive"}:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_rgb_roundtrip(tmp_path):
    _, g = both(scene(30, 1))
    tply.save_gaussians_ply(tmp_path / "m.ply", g)
    g2 = tply.load_gaussians_ply(tmp_path / "m.ply", device="cpu")
    np.testing.assert_allclose(g2.means, g.means, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g2.scales, g.scales, rtol=1e-4)
    np.testing.assert_allclose(g2.opacities, g.opacities, rtol=1e-4)
    np.testing.assert_allclose(g2.colors, g.colors, rtol=1e-3, atol=1e-5)


def test_sh_and_quats_roundtrip(tmp_path):
    arr = scene(20, 3, bands=4, quats=True)
    arr["quats"] = np.abs(arr["quats"] / np.linalg.norm(
        arr["quats"], axis=1, keepdims=True))
    _, g = both(arr)
    tply.save_gaussians_ply(tmp_path / "m.ply", g)
    g2 = tply.load_gaussians_ply(tmp_path / "m.ply", device="cpu")
    # dc clamped to [0,1] on export (render contract), rest exact
    np.testing.assert_allclose(g2.sh[:, 0], g.sh[:, 0].clamp(0, 1),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(g2.sh[:, 1:], g.sh[:, 1:], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(g2.quats, g.quats, rtol=1e-4, atol=1e-5)


def test_ply_follows_3dgs_conventions(tmp_path):
    """The on-disk values against the ecosystem conventions: log scales,
    logit opacity, (rgb-0.5)/C0 dc."""
    _, g = both(scene(5, 7))
    path = tmp_path / "m.ply"
    tply.save_gaussians_ply(path, g)
    raw = path.read_bytes()
    end = raw.find(b"end_header\n")
    props = [line.split()[2] for line in raw[:end].decode().splitlines()
             if line.startswith("property")]
    arr = np.frombuffer(raw[end + 11:], dtype="<f4").reshape(5, len(props))
    col = {p: i for i, p in enumerate(props)}
    np.testing.assert_allclose(arr[:, col["scale_0"]],
                               np.log(g.scales[:, 0].numpy()), rtol=1e-4)
    op = g.opacities.numpy()
    np.testing.assert_allclose(arr[:, col["opacity"]], np.log(op / (1 - op)),
                               rtol=1e-3)
    np.testing.assert_allclose(arr[:, col["f_dc_0"]],
                               (g.colors[:, 0].numpy() - 0.5) / tply.SH_C0,
                               rtol=1e-4, atol=1e-5)


def test_sh_render_equivalence_through_ply(tmp_path):
    """Rendering the ply-roundtripped SH model matches the original with
    its dc clamped as export clamps it (the basis mapping, not just the
    roundtrip algebra)."""
    _, g = both(scene(15, 9, bands=4))
    tply.save_gaussians_ply(tmp_path / "m.ply", g)
    g2 = tply.load_gaussians_ply(tmp_path / "m.ply", device="cpu")
    c = tcam.orbit_cameras(3, 32, 32, device="cpu")[1]
    cfg = RenderConfig(width=32, height=32, impl="torch", chunk_size=8)
    sh_c = g.sh.clone()
    sh_c[:, 0] = sh_c[:, 0].clamp(0, 1)
    img1 = render(g.replace(sh=sh_c), c, cfg)
    img2 = render(g2.replace(quats=None), c, cfg)
    np.testing.assert_allclose(img2, img1, atol=1e-4)


def test_convert_cli(tmp_path, capsys):
    """npz -> ply -> npz through the port's CLI; its ply is JAX's CLI's
    byte for byte, and it prints what JAX's prints."""
    _, g = both(scene(8, 11))
    npz = tmp_path / "m.npz"
    save_gaussians_npz(npz, g)
    tconvert.main([str(npz), str(tmp_path / "t.ply")])
    jconvert.main([str(npz), str(tmp_path / "j.ply")])
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("t.ply", "j.ply") == out[1]
    tconvert.main([str(tmp_path / "t.ply"), str(tmp_path / "m2.npz")])
    g2 = load_gaussians_npz(tmp_path / "m2.npz", device="cpu")
    np.testing.assert_allclose(g2.means, g.means, rtol=1e-5, atol=1e-6)

"""Port parity, the native binding: tests/test_native.py's cases through
`tpu_gaussians_torch.native` (the oracle tolerances as there), and the
port's binding against `tpu_gaussians.native` on the same inputs, bit for
bit (the same C++)."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_gaussians_torch import native
from tpu_gaussians_torch.io.npz import save_gaussians_npz
from tpu_gaussians_torch.core.types import gaussians_from_numpy

from . import np_oracle
from .utils import orbit_camera, random_scene

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)

W, H = 64, 48
ROOT = Path(__file__).resolve().parent.parent


def _scene_args(n=40, seed=0):
    g = random_scene(n, seed=seed)
    c = orbit_camera(W, H, index=1)
    return (
        np.asarray(g.means), np.asarray(g.scales), np.asarray(g.colors),
        np.asarray(g.opacities), np.asarray(c.view), np.asarray(c.proj),
    )


def test_build_lands_in_the_port_build_dir():
    before = {p: p.stat().st_mtime_ns
              for p in (ROOT / "native").rglob("*") if p.is_file()}
    lib = native.build()
    viewer = native.viewer_path()
    assert lib.parent == viewer.parent == ROOT / "tpu_gaussians_torch" / \
        "_build"
    assert lib.exists() and viewer.exists()
    assert {p: p.stat().st_mtime_ns for p in (ROOT / "native").rglob("*")
            if p.is_file()} == before


def test_failed_build_raises_with_gxx_output(monkeypatch):
    monkeypatch.setattr(native, "FLAGS",
                        native.FLAGS + ["-fno-such-option-anywhere"])
    with pytest.raises(native.NativeBuildError,
                       match="unrecognized command-line option"):
        native.build()
    assert not native.target_path("libgs_rasterizer").exists()


@pytest.mark.parametrize("depth_sort", [False, True])
def test_modes_match_oracle(depth_sort):
    seed, bg = (3, (0.02, 0.02, 0.02)) if depth_sort else (0, (0.1, 0.2, 0.3))
    means, scales, colors, opacities, view, proj = _scene_args(seed=seed)
    rgb, alpha = native.render_native(
        means, scales, colors, opacities, view, proj,
        width=W, height=H, background=bg, depth_sort=depth_sort,
        as_float=True,
    )
    oracle = (np_oracle.render_sorted if depth_sort
              else np_oracle.render_accum)
    ref_img, ref_alpha, _ = oracle(means, scales, colors, opacities, view,
                                   proj, W, H, background=bg)
    # The native path cuts splats at w < 1e-5 (adaptive radius); with up to
    # N contributions the accumulated deviation is bounded by ~N*1e-5.
    np.testing.assert_allclose(rgb, ref_img, atol=5e-4)
    np.testing.assert_allclose(alpha, ref_alpha, atol=5e-4)


def test_rgba8_output():
    args = _scene_args(seed=5)
    out = native.render_native(*args, width=W, height=H)
    assert out.shape == (H, W, 4) and out.dtype == np.uint8
    assert (out[..., 3] == 255).all()
    assert out[..., :3].max() > 0  # something rendered


def test_input_validation():
    means, scales, colors, opacities, view, proj = _scene_args()
    with pytest.raises(ValueError):
        native.render_native(means[:, :2], scales, colors, opacities,
                             view, proj, width=W, height=H)
    with pytest.raises(ValueError):
        native.render_native(means, scales[:-1], colors, opacities,
                             view, proj, width=W, height=H)
    with pytest.raises(ValueError):
        native.render_native(means, scales, colors, opacities[:-1],
                             view, proj, width=W, height=H)


@pytest.mark.parametrize("depth_sort", [False, True])
def test_bit_identical_to_jax_binding(depth_sort):
    """The same inputs through both bindings, as numpy arrays and (the
    port) as torch tensors: the same bytes out."""
    jnative = pytest.importorskip("tpu_gaussians.native")
    args = _scene_args(seed=7)
    kw = dict(width=W, height=H, background=(0.1, 0.0, 0.2),
              depth_sort=depth_sort)
    for as_float in (False, True):
        j_out = jnative.render_native(*args, as_float=as_float, **kw)
        t_out = native.render_native(*args, as_float=as_float, **kw)
        t_torch = native.render_native(*(torch.tensor(a) for a in args),
                                       as_float=as_float, **kw)
        outs = [j_out, t_out, t_torch]
        if not as_float:          # one RGBA8 frame, not an (rgb, alpha)
            outs = [(o,) for o in outs]
        for a, b, c in zip(*outs):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_viewer_binary(tmp_path):
    g = random_scene(25, seed=7)
    arrays = {k: np.asarray(getattr(g, k)) for k in
              ("means", "scales", "opacities", "colors")}
    npz = tmp_path / "model.npz"
    save_gaussians_npz(npz, gaussians_from_numpy(arrays, device="cpu"))

    out_dir = tmp_path / "frames"
    res = subprocess.run(
        [str(native.viewer_path()), str(npz), "--width", "64", "--height",
         "48", "--frames", "3", "--out_dir", str(out_dir)],
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "FPS" in res.stdout
    frames = sorted(out_dir.glob("frame_*.ppm"))
    assert len(frames) == 3
    header = frames[0].read_bytes()[:20]
    assert header.startswith(b"P6\n64 48\n255\n")

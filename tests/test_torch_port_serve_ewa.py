"""The viewer draws what 3DGS trainers export (CPU, the kernels' plain
twins): `cli.serve.RenderService` and `cli.render` resolve the footprint
from the model (EWA where the npz carries quaternions, else axis), and a
served EWA SH3 frame agrees with the benchmark's plain reference
(`gsbench.reference.render`) where the axis draw of the same scene does
not. Also the binner's counters (`utils.profiling.count`): nothing without
a profiler, and under one a served frame's pairs, dropped and clipped
overlaps under the frame's root."""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gsbench import scene
from gsbench.reference import render as R
from tpu_gaussians_torch.cli import eval as teval_cli
from tpu_gaussians_torch.cli import render as trender_cli
from tpu_gaussians_torch.cli import serve as tserve
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig, make_gaussians
from tpu_gaussians_torch.io.image import save_image_png
from tpu_gaussians_torch.io.npz import save_gaussians_npz
from tpu_gaussians_torch.ops import sorted as tsorted
from tpu_gaussians_torch.ops.dispatch import render
from tpu_gaussians_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
W, H, N = 160, 96, 2000
POSES = [(0.3, 0.2, 2.5), (4.0, 0.6, 2.7777777777777777)]
# Served frames against the reference: the share of u8 values more than 1
# apart. The twins and the reference compute the same f32 terms in other
# orders, so a value near a rounding edge of the u8 quantisation may move
# by one step, and a gaussian at its alpha cut-off or a tile edge by a few:
# 1e-3 of the values, an eighth of the benchmark's serve limit (8e-3).
SHARE_OFF = 1e-3


def ewa_config() -> dict:
    cfg = json.loads((REPO / "gsbench/configs/gs1m_ewa_sh3.json").read_text())
    cfg["num_gaussians"] = cfg["capacity"] = N
    return cfg


@pytest.fixture(scope="module")
def ewa_scene(tmp_path_factory):
    """(activated scene dict, npz path) of N seeded EWA SH3 gaussians."""
    cfg = ewa_config()
    g = scene.make_scene(cfg, 11, "cpu")
    path = tmp_path_factory.mktemp("serve_ewa") / "ewa.npz"
    save_gaussians_npz(path, make_gaussians(
        g["means"], g["scales"], g["opacities"], sh=g["sh"],
        quats=g["quats"], device="cpu"))
    return g, str(path)


@pytest.fixture(scope="module")
def axis_npz(tmp_path_factory):
    rng = np.random.default_rng(3)
    n = 400
    g = make_gaussians(
        rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
        rng.uniform(0.02, 0.1, (n, 3)).astype(np.float32),
        rng.uniform(0.2, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32), device="cpu")
    path = tmp_path_factory.mktemp("serve_axis") / "axis.npz"
    save_gaussians_npz(path, g)
    return str(path)


def reference_frame(g, pose) -> np.ndarray:
    """The reference's u8 frame of the EWA SH3 scene under the quality
    preset's knobs."""
    k, cap, exit_t = R.sorted_knobs(N, "quality")
    view = R.look_at(R.orbit_eye(*pose), "cpu")
    proj = R.perspective(60.0, W / H, 0.01, 100.0, "cpu")
    st = R.screen_stage(g, view, proj, W, H, ewa_config())
    slots, cnt = R.tile_lists(st, W, H, k, cap)
    acc, _ = R.composite_frame(R.rows_table(st), slots, cnt, W, H,
                               exit_t=exit_t)
    return R.to_u8(R.resolve(acc, R.VIEWER_BACKGROUND)).numpy()


def share_off(served: np.ndarray, ref: np.ndarray) -> float:
    d = np.abs(served.astype(np.int16) - ref.astype(np.int16))
    return float((d > 1).mean())


@pytest.fixture(scope="module")
def references(ewa_scene):
    g, _ = ewa_scene
    return [reference_frame(g, pose) for pose in POSES]


@pytest.mark.parametrize("footprint", ["auto", "axis"])
def test_served_ewa_frame_against_the_reference(ewa_scene, references,
                                                footprint):
    """auto resolves to EWA on a model with quaternions and agrees with
    the reference; the axis draw of the same scene (the service before the
    footprint followed the model) fails that comparison."""
    _, path = ewa_scene
    svc = tserve.RenderService(path, preset="quality", device="cpu",
                               footprint=footprint)
    assert svc.footprint == ("ewa" if footprint == "auto" else "axis")
    shares = [share_off(svc.render_frame(*pose, W, H, "sorted"), ref)
              for pose, ref in zip(POSES, references)]
    if footprint == "auto":
        assert max(shares) <= SHARE_OFF, shares
    else:
        assert min(shares) > 10 * SHARE_OFF, shares


def test_a_model_without_quaternions_draws_as_before(axis_npz):
    """auto resolves to axis, and the frame is bit for bit the render of a
    RenderConfig that names no footprint."""
    svc = tserve.RenderService(axis_npz, preset="quality", device="cpu")
    assert svc.footprint == "axis"
    pose = (0.4, 0.25, 2.3)
    served = svc.render_frame(*pose, W, H, "sorted")
    with torch.no_grad():
        img = render(svc.gaussians, svc.camera(*pose, W, H),
                     RenderConfig(width=W, height=H, mode="sorted",
                                  background=(0.02, 0.02, 0.02)))
    before = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).numpy()
    np.testing.assert_array_equal(served, before)


def test_ewa_without_quaternions_raises(axis_npz):
    with pytest.raises(ValueError, match="quaternions"):
        tserve.RenderService(axis_npz, device="cpu", footprint="ewa")


def test_the_clis_refuse_ewa_without_quaternions(axis_npz, tmp_path):
    """cli.render and cli.eval resolve the footprint as the service does
    (core.types.resolve_footprint): "ewa" on a model without quaternions
    raises before anything is drawn."""
    with pytest.raises(ValueError, match="quaternions"):
        trender_cli.main([axis_npz, "--out_dir", str(tmp_path), "--width",
                          str(W), "--height", str(H), "--device", "cpu",
                          "--footprint", "ewa"])
    (tmp_path / "t").mkdir()
    save_image_png(tmp_path / "t" / "v0.png",
                   np.full((H, W, 3), 0.5, np.float32))
    with pytest.raises(ValueError, match="quaternions"):
        teval_cli.main([axis_npz, "--targets_dir", str(tmp_path / "t"),
                        "--width", str(W), "--height", str(H), "--device",
                        "cpu", "--footprint", "ewa"])
    assert not list(tmp_path.glob("*.png"))


def test_info_reports_the_footprint(ewa_scene, axis_npz):
    for path, want in ((ewa_scene[1], "ewa"), (axis_npz, "axis")):
        svc = tserve.RenderService(path, device="cpu")
        server = ThreadingHTTPServer(("127.0.0.1", 0),
                                     tserve.make_handler(svc))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/info"
            with urllib.request.urlopen(url, timeout=30) as r:
                info = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
        assert info["footprint"] == want
        assert info["quats"] is (want == "ewa")


def test_render_cli_draws_a_quaternion_model_with_ewa(ewa_scene, tmp_path):
    """cli.render's default footprint resolves as the service's: its PNG
    of a quaternion-carrying model is the EWA render, not the axis one."""
    _, path = ewa_scene
    trender_cli.main([path, "--out_dir", str(tmp_path), "--width", str(W),
                      "--height", str(H), "--device", "cpu"])
    png = np.asarray(Image.open(tmp_path / "view_000.png").convert("RGB"))
    svc = tserve.RenderService(path, device="cpu")
    cams = tcam.orbit_cameras(1, W, H, device="cpu")

    def u8(footprint):
        cfg = RenderConfig(width=W, height=H, mode="sorted",
                           footprint=footprint,
                           background=(0.02, 0.02, 0.02))
        with torch.no_grad():
            img = render(svc.gaussians, cams, cfg)
        img = img[0] if img.ndim == 4 else img
        return (np.clip(img.numpy(), 0.0, 1.0) * 255.0)

    ewa, axis = u8("ewa"), u8("axis")
    assert np.abs(png - ewa).max() <= 1.0
    assert np.abs(png - axis).max() > 10.0


def test_count_records_nothing_without_a_profiler(ewa_scene):
    before = len(profiling.counters())
    profiling.count("gs.test", torch.ones(()))
    svc = tserve.RenderService(ewa_scene[1], device="cpu")
    svc.render_frame(*POSES[0], W, H, "sorted")
    assert len(profiling.counters()) == before


def test_a_served_frame_counts_its_binner_pairs(ewa_scene, monkeypatch):
    """Under torch.profiler one served frame records gs.binner.pairs,
    .dropped and .clipped inside the span gs.binner, under the frame's
    root, with the binner's tensors as they are; pairs less dropped is
    what the tile lists hold."""
    svc = tserve.RenderService(ewa_scene[1], preset="interactive",
                               device="cpu")
    lists = []
    tile_lists = tsorted.tile_lists

    def keep(*a, **kw):
        out = tile_lists(*a, **kw)
        lists.append(out)
        return out

    monkeypatch.setattr(tsorted, "tile_lists", keep)
    before_counts, before_spans = (len(profiling.counters()),
                                   len(profiling.spans()))
    with torch.profiler.profile():
        svc.render_frame(*POSES[1], W, H, "sorted")
    counts = profiling.counters()[before_counts:]
    spans = profiling.spans()[before_spans:]
    (frame,) = [s for s in spans if s.name == "gs.serve.frame"]
    (binner,) = [s for s in spans if s.name == "gs.binner"]
    assert [c.name for c in counts] == ["gs.binner.pairs",
                                        "gs.binner.dropped",
                                        "gs.binner.clipped"]
    assert all(c.root == frame.id and c.span == binner.id
               and c.thread == threading.get_ident() for c in counts)
    (_, cnt, _, _, stats), = lists
    value = {c.name: c.value for c in counts}
    assert value["gs.binner.dropped"] is stats["dropped_pairs"]
    assert value["gs.binner.clipped"] is stats["clipped_rect_pairs"]
    pairs, dropped = (int(value[k]) for k in ("gs.binner.pairs",
                                              "gs.binner.dropped"))
    assert pairs > 0 and pairs - dropped == int(cnt.sum())

"""Port parity, the entry points: the render server (`cli.serve`) and the
render CLI of `tpu_gaussians_torch` against the JAX package's on an npz
the JAX package wrote (CPU)."""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tpu_gaussians.cli import serve as jserve
from tpu_gaussians.core.types import make_gaussians
from tpu_gaussians.io.npz import save_gaussians_npz
from tpu_gaussians_torch.cli import render as trender_cli
from tpu_gaussians_torch.cli import serve as tserve

W, H = 128, 48


@pytest.fixture(scope="module")
def scene_npz(tmp_path_factory):
    rng = np.random.default_rng(0)
    n = 300
    g = make_gaussians(
        rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
        rng.uniform(0.02, 0.15, (n, 3)).astype(np.float32),
        rng.uniform(0.2, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    path = tmp_path_factory.mktemp("serve") / "scene.npz"
    save_gaussians_npz(path, g)
    return str(path)


@pytest.mark.parametrize("preset", ["interactive", "quality"])
def test_served_frame_matches_jax_service(scene_npz, preset):
    """uint8 frames agree to 1 LSB on at most 0.1% of the values."""
    pose = (0.4, 0.25, 2.3, W, H, "sorted")
    j = jserve.RenderService(scene_npz, "pallas", 60.0, preset)
    t = tserve.RenderService(scene_npz, "auto", 60.0, preset, device="cpu")
    jf = j.render_frame(*pose)
    tf = t.render_frame(*pose)
    assert tf.dtype == np.uint8 and tf.shape == jf.shape == (H, W, 3)
    diff = np.abs(tf.astype(np.int16) - jf.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert t.frames == 1


def test_handler_answers_info_and_render(scene_npz):
    svc = tserve.RenderService(scene_npz, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["num_gaussians"] == 300 and info["impl"] == "auto"
        assert info["preset"] == "interactive" and info["device"] == "cpu"
        url = base + f"/render?yaw=0.4&pitch=0.25&radius=2.3&width={W}&height={H}"
        with urllib.request.urlopen(url + "&format=raw", timeout=60) as r:
            raw = np.frombuffer(r.read(), np.uint8).reshape(H, W, 4)
            assert r.headers["X-Preset"] == "interactive"
        np.testing.assert_array_equal(
            raw[..., :3], svc.render_frame(0.4, 0.25, 2.3, W, H, "sorted"))
        with urllib.request.urlopen(url + "&format=png", timeout=60) as r:
            assert r.headers["Content-Type"] == "image/png"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "&mode=accum", timeout=60)
        assert err.value.code == 400
        with urllib.request.urlopen(base + "/", timeout=30) as r:
            assert b"viewer" in r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_concurrent_requests_count_every_frame(scene_npz):
    """The server's threads share one RenderService: with more threads
    than cores and a short switch interval, no frame count is lost and
    every frame equals the single-threaded one."""
    import os
    import sys

    svc = tserve.RenderService(scene_npz, device="cpu")
    ref = svc.render_frame(0.1, 0.2, 2.5, 64, 32, "sorted")
    frames, errors = [], []

    def worker():
        try:
            for _ in range(3):
                frames.append(svc.render_frame(0.1, 0.2, 2.5, 64, 32,
                                               "sorted"))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=worker)
               for _ in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert svc.frames == 1 + 3 * len(threads) == 1 + len(frames)
    assert all(np.array_equal(f, ref) for f in frames)


def test_run_loop_keeps_json_keys(scene_npz, capsys):
    j_svc = jserve.RenderService(scene_npz, "jnp", 60.0, "interactive")
    jserve.run_loop(j_svc, frames=2, width=64, height=32, mode="accum",
                    fmt="raw")
    j_keys = set(json.loads(capsys.readouterr().out.splitlines()[-1]))
    svc = tserve.RenderService(scene_npz, device="cpu")
    out = tserve.run_loop(svc, frames=3, width=64, height=32, mode="sorted",
                          fmt="jpg")
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert j_keys <= set(printed)
    assert printed["frames"] == 3 and out["n_gaussians"] == 300
    assert printed["device_ms_per_frame"] is None   # no device clock on CPU
    assert printed["sustained_fps_this_host"] > 0
    assert svc.frames == 4                          # warm-up + 3


def test_service_refuses_cuda_without_card(scene_npz):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.RenderService(scene_npz, device="cuda")


def test_render_cli_writes_pngs(scene_npz, tmp_path):
    from PIL import Image

    trender_cli.main([scene_npz, "--out_dir", str(tmp_path), "--width", "64",
                      "--height", "32", "--num_views", "2", "--device",
                      "cpu"])
    for i in range(2):
        assert Image.open(tmp_path / f"view_{i:03d}.png").size == (64, 32)
    with pytest.raises(NotImplementedError, match="slice 2"):
        trender_cli.main([scene_npz, "--mode", "accum", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="parallel"):
        trender_cli.main([scene_npz, "--shard_bands", "2", "--device",
                          "cpu"])

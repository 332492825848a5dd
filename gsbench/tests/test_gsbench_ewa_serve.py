"""The EWA SH3 serve cell on the CPU (the tiny tree of tiny.py, the port
through its kernels' plain twins): a sound run is correct, a traced run
reads the binner's counter metrics, the axis draw of the EWA scene (the
service before its footprint followed the model) fails the cell's check,
and the reference's frame of gs1m_ewa_sh3 agrees with the port's EWA
render."""

import json

import pytest
import torch

from gsbench.reference import render as R
from gsbench.tests.test_gsbench_runs import run_main
from gsbench.tests.tiny import REPO, tiny_root

EWA_SERVE = "serve_1m_ewa_quality_1080p"
COUNTERS = ("binner_pairs_m.serve", "binner_lost_pct.serve")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("gsbench_ewa"))


def test_sound_run_is_correct(root):
    res = run_main(root, EWA_SERVE)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert {"serve_fps", "setup_s"} <= set(res["metrics"])


def test_traced_run_reads_the_counter_metrics(root):
    res = run_main(root, EWA_SERVE, trace=1)
    assert res["correct"]
    m = res["metrics"]
    assert m["binner_pairs_m.serve"]["value"] > 0
    assert 0 <= m["binner_lost_pct.serve"]["value"] < 100
    assert "lock_held_ms.serve" in m and "host_ops.serve" in m


def test_the_axis_draw_fails_the_check(root, monkeypatch):
    from tpu_gaussians_torch.cli import serve as tserve

    class AxisService(tserve.RenderService):
        def __init__(self, *a, **kw):
            super().__init__(*a, footprint="axis", **kw)

    monkeypatch.setattr(tserve, "RenderService", AxisService)
    res = run_main(root, EWA_SERVE)
    assert res["correct"] is False
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


def test_reference_frame_matches_the_port_ewa():
    """gs1m_ewa_sh3's representation in the reference against the port's
    sorted render with footprint="ewa", as test_gsbench_runs holds the
    other configurations."""
    from gsbench import scene
    from tpu_gaussians_torch.core.types import (
        Camera, RenderConfig, make_gaussians)
    from tpu_gaussians_torch.ops.dispatch import render

    cfg = json.loads((REPO / "gsbench/configs/gs1m_ewa_sh3.json").read_text())
    cfg["num_gaussians"] = 3000
    g = scene.make_scene(cfg, 7, "cpu")
    w, h = 250, 50
    view = R.look_at(R.orbit_eye(0.3, 0.2, 2.5), "cpu")
    proj = R.perspective(60.0, w / h, 0.01, 100.0, "cpu")
    port = render(make_gaussians(g["means"], g["scales"], g["opacities"],
                                 sh=g["sh"], quats=g["quats"], device="cpu"),
                  Camera(view=view, proj=proj),
                  RenderConfig(width=w, height=h, mode="sorted",
                               footprint="ewa"))
    k, cap, exit_t = R.sorted_knobs(cfg["num_gaussians"])
    st = R.screen_stage(g, view, proj, w, h, cfg)
    slots, cnt = R.tile_lists(st, w, h, k, cap)
    acc, _ = R.composite_frame(R.rows_table(st), slots, cnt, w, h,
                               exit_t=exit_t)
    ref = R.resolve(acc, [0.0, 0.0, 0.0])
    assert torch.allclose(port, ref, atol=1e-5)

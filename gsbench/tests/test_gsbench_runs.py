"""Whole runs of the tiny cells on the CPU, the port through its kernels'
plain twins: sound runs come out correct, each planted fault does not,
and the reference's frame agrees with the port's renderer."""

import contextlib
import importlib.util
import io
import json
import shutil

import pytest
import torch

from gsbench import faults
from gsbench.reference import render as R
from gsbench.tests.tiny import FIT, REPO, SERVE, tiny_root

SEED = 2**31 + 12345      # larger than 32 signed bits hold


def run_main(root, cell, trace=0, seed=SEED):
    spec = importlib.util.spec_from_file_location("gsbench_run",
                                                  REPO / "gsbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "1", "--trace", str(trace)], allow_cpu=True, root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("gsbench"))


@pytest.mark.parametrize("cell", [FIT, SERVE])
def test_sound_run_is_correct(root, cell):
    res = run_main(root, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    names = list(res)
    assert names[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", [FIT, SERVE])
def test_traced_run_reads_its_metrics(root, cell):
    res = run_main(root, cell, trace=1)
    assert res["correct"]
    kind = "fit" if cell == FIT else "serve"
    assert f"host_ops.{kind}" in res["metrics"]
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,fault", [(FIT, f) for f in faults.KINDS["fit"]]
                         + [(SERVE, f) for f in faults.KINDS["serve"]])
def test_planted_fault_is_caught(root, cell, fault):
    """Each fault, planted in a whole run of the tiny cell, comes out not
    correct. At the cells' own sizes (PERF.md) every fit fault and the
    served stale frame fail a number too, but the served `altered_tile`
    does not: one tile of a 1920x1080 frame moves the frame's share and
    mean less than their limits allow, where one of the tiny frame's six
    tiles does not."""
    with faults.planted(fault):
        res = run_main(root, cell)
    assert res["correct"] is False


def test_a_route_the_reference_lacks_is_refused(root):
    """A fit cell whose configuration the trainer would fit on another
    route than the sorted one is refused before it runs."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "fit_axis", "config": "gs1m_axis_sh1",
                           "traffic": "fit_4views_1080p", "chips": 1,
                           "why": "x"})
    other = root.parent / "bench_axis"
    shutil.copytree(root, other)
    (other / "BENCHMARK.json").write_text(json.dumps(b))
    (other / "gsbench/workloads/fit_axis.json").write_text(
        (root / f"gsbench/workloads/{FIT}.json").read_text())
    with pytest.raises(ValueError, match="sorted route only"):
        run_main(other, "fit_axis")


@pytest.mark.parametrize("config", ["gs100k_ewa_sh3", "gs1m_axis_sh1"])
def test_reference_frame_matches_the_port(config):
    """The reference's frame of each configuration's representation (its
    footprint, SH degree and basis) against the port's sorted render."""
    from tpu_gaussians_torch.core.types import Camera, RenderConfig
    from tpu_gaussians_torch.core.types import make_gaussians
    from tpu_gaussians_torch.ops.dispatch import render
    from gsbench import scene

    cfg = json.loads((REPO / f"gsbench/configs/{config}.json").read_text())
    cfg["num_gaussians"] = 3000
    g = scene.make_scene(cfg, 7, "cpu")
    w, h = 250, 50
    view = R.look_at(R.orbit_eye(0.3, 0.2, 2.5), "cpu")
    proj = R.perspective(60.0, w / h, 0.01, 100.0, "cpu")
    port = render(make_gaussians(g["means"], g["scales"], g["opacities"],
                                 sh=g["sh"], quats=g.get("quats"),
                                 device="cpu"),
                  Camera(view=view, proj=proj),
                  RenderConfig(width=w, height=h, mode="sorted",
                               footprint=cfg["footprint"]))
    k, cap, exit_t = R.sorted_knobs(cfg["num_gaussians"])
    st = R.screen_stage(g, view, proj, w, h, cfg)
    slots, cnt = R.tile_lists(st, w, h, k, cap)
    acc, _ = R.composite_frame(R.rows_table(st), slots, cnt, w, h,
                               exit_t=exit_t)
    ref = R.resolve(acc, [0.0, 0.0, 0.0])
    assert torch.allclose(port, ref, atol=1e-5)

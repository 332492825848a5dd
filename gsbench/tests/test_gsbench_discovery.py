"""Discovery of cells, configurations, traffic mixes and metrics by name,
and BENCHMARK.json against the benchmark's contract."""

import json
import re
import shutil

import pytest

from gsbench import harness
from gsbench.tests.tiny import FIT, REPO, SERVE

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [FIT, SERVE])
def test_cells_resolve(cell):
    c = harness.find_cell(REPO, cell)
    assert c["traffic"]["kind"] in ("fit", "serve")
    harness.traffic_kind(REPO, c["traffic"]["kind"])
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"] and c["limits"]


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gsbench"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gsbench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}
    cells = {w["name"]: w for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        reader = REPO / "gsbench" / "metrics" / f"{m['name']}.py"
        mod = harness.load_module(reader, "r_" + m["name"].replace(".", "_"))
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_readers_find_nothing_in_the_other_kind():
    """A reader of one kind's cells returns None on the other's facts."""
    empty = {"window_s": 1.0, "busy_s": 0.5, "host_ops": 10, "calls": 2,
             "device": [], "top_ops": [], "idle_gaps": []}
    for m in bench()["per_layer"]:
        mod = harness.load_module(
            REPO / "gsbench" / "metrics" / f"{m['name']}.py", "r")
        other = "serve" if m["name"].endswith(("fit", "fit_mfu")) else "fit"
        assert mod.read({"kind": other, "a": empty, "b": empty}) is None


def test_a_cell_added_as_files(tmp_path):
    """A new configuration, mix, cell and metric, each a file of its own
    plus entries in BENCHMARK.json, are found with no edit of a file."""
    root = tmp_path / "bench"
    shutil.copytree(REPO / "gsbench", root / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((REPO / "gsbench/configs/gs100k_ewa_sh3.json").read_text())
    cfg["name"] = "gs200k_ewa_sh3"
    cfg["num_gaussians"] = cfg["capacity"] = 200000
    (root / "gsbench/configs/gs200k_ewa_sh3.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "gsbench/traffic/fit_4views_1080p.json").read_text())
    mix["views_per_step"] = 2
    (root / "gsbench/traffic/fit_2views_1080p.json").write_text(json.dumps(mix))
    (root / "gsbench/workloads/fit_200k.json").write_text(
        json.dumps({"limits": {"loss_gap": 1, "grad_gap": 1,
                               "change_gap": 1}}))
    (root / "gsbench/metrics/steps_seen.py").write_text(
        "UNIT = 'steps'\nLAYER = 'train step'\nMOVES = 'fit_mpix_s'\n"
        "def read(facts):\n    return facts['a']['calls']\n")
    b["configs"].append({"name": "gs200k_ewa_sh3", "source": "x",
                         "file": "gsbench/configs/gs200k_ewa_sh3.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "fit_200k", "config": "gs200k_ewa_sh3",
                           "traffic": "fit_2views_1080p", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "fit_mpix_s":
            m["workloads"].append("fit_200k")
    b["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "device_trace",
                           "layer": "train step", "moves": "fit_mpix_s",
                           "workloads": ["fit_200k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = harness.find_cell(root, "fit_200k")
    assert c["config"]["num_gaussians"] == 200000
    assert c["traffic"]["views_per_step"] == 2
    assert [m["name"] for m in c["per_layer"]] == ["steps_seen"]
    assert {m["name"] for m in c["end_to_end"]} == {"fit_mpix_s", "setup_s"}
    got = harness.read_metrics(root, c["per_layer"], {"a": {"calls": 7}})
    assert got == {"steps_seen": {"value": 7, "unit": "steps"}}

"""The span-based per-layer metrics on the CPU: a traced run of each tiny
cell reports the host-time metrics read from the program's spans, while
the device-time readers find no device track and return None, as the
frame-based ones do; a reader whose buffer holds fewer roots than the
windows' calls, or a program without spans, returns None."""

import pytest

from gsbench import harness
from gsbench.tests.test_gsbench_runs import run_main
from gsbench.tests.tiny import FIT, REPO, SERVE, tiny_root

HOST = {FIT: ("host_step_ms.fit", "host_bwd_ms.fit"),
        SERVE: ("lock_held_ms.serve", "lock_wait_ms.serve")}
DEVICE = {FIT: ("stage_fwd_ms.fit", "binner_span_ms.fit",
                "composite_fwd_span_roofline.fit",
                "composite_bwd_span_roofline.fit"),
          SERVE: ("stage_ms.serve", "binner_span_ms.serve",
                  "composite_fwd_span_roofline.serve")}


def reader(name):
    return harness.load_module(REPO / "gsbench" / "metrics" / f"{name}.py",
                               "r_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("gsbench_spans"))


@pytest.mark.parametrize("cell", [FIT, SERVE])
def test_traced_run_reads_the_span_metrics(root, cell):
    res = run_main(root, cell, trace=1)
    assert res["correct"]
    for name in HOST[cell]:
        assert res["metrics"][name]["value"] > 0, name
    if cell == FIT:
        m = res["metrics"]
        assert m["host_bwd_ms.fit"]["value"] < m["host_step_ms.fit"]["value"]
    for name in DEVICE[cell]:
        assert name not in res["metrics"]


@pytest.mark.parametrize("name", HOST[FIT] + HOST[SERVE])
def test_a_reader_short_of_roots_returns_none(name, monkeypatch):
    from tpu_gaussians_torch.utils import profiling

    kind = name.rsplit(".", 1)[1]
    facts = {"kind": kind, "a": {"calls": 2}, "b": {"calls": 1}}
    root = {"fit": "gs.fit.step", "serve": "gs.serve.frame"}[kind]
    two = [profiling.Span(root, 1, 0, 10**6, i, None, i) for i in (1, 2)]
    monkeypatch.setattr(profiling, "spans", lambda: two)
    assert reader(name).read(facts) is None          # 2 roots, 3 calls
    monkeypatch.setattr(profiling, "spans", lambda: two + [
        profiling.Span(root, 1, 0, 10**6, 3, None, 3)])
    got = reader(name).read(facts)
    assert got is None or got == pytest.approx(1.0)   # the roots alone
    monkeypatch.delattr(profiling, "spans")          # a program without
    assert reader(name).read(facts) is None


SPAN = {"stage_fwd_ms.fit": "gs.stage", "stage_ms.serve": "gs.stage",
        "binner_span_ms.fit": "gs.binner",
        "binner_span_ms.serve": "gs.binner",
        "composite_fwd_span_roofline.fit": "gs.composite.fwd",
        "composite_fwd_span_roofline.serve": "gs.composite.fwd",
        "composite_bwd_span_roofline.fit": "gs.composite.bwd"}


class Bound:
    def bound_s(self):
        return 1e-4


@pytest.mark.parametrize("name", DEVICE[FIT] + DEVICE[SERVE])
def test_a_device_reader_needs_its_span(name):
    """A trace without the reader's span (the program before the spans)
    gives None, though the binner's backward node is in it; with the span,
    the device time launched inside it is read."""
    kind = name.rsplit(".", 1)[1]
    node = ("autograd::engine::evaluate_function: IndexSelectBackward0",)
    facts = {"kind": kind, "b": {"calls": 2, "device": [("k", 2e-3, node)]},
             "work_b": {"composite_fwd": Bound(), "composite_bwd": Bound()}}
    assert reader(name).read(facts) is None
    facts["b"]["device"].append(("k", 1e-3, ("gs.fit.step", SPAN[name])))
    got = reader(name).read(facts)
    if name.startswith("binner"):
        assert got == pytest.approx(1.5)       # (1 + 2) ms over 2 calls
    elif name.startswith("stage"):
        assert got == pytest.approx(0.5)
    else:
        assert got == pytest.approx(10.0)      # 0.1 ms bound over 1 ms

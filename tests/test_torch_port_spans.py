"""The port's spans (`utils.profiling.annotate`, CPU): free when no
profiler runs; under `profiling.trace` a sorted train step and a served
frame record their layer spans under one root, the backward's spans
included (a CPU backward runs on the thread that calls it), and each
record lies on the written Chrome trace's clock."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.cli import serve as tserve
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import Camera, RenderConfig
from tpu_gaussians_torch.core.types import make_gaussians
from tpu_gaussians_torch.fit.loss import LossConfig
from tpu_gaussians_torch.fit.step import (
    init_state, make_optimizer, make_train_step)
from tpu_gaussians_torch.io.npz import save_gaussians_npz
from tpu_gaussians_torch.models.gaussian_model import init_params
from tpu_gaussians_torch.utils import profiling

STEP_SPANS = ("gs.fit.step", "gs.fit.backward", "gs.stage", "gs.binner",
              "gs.composite.fwd", "gs.composite.bwd")
CLOCK_US = 100.0     # a record against its range in the Chrome trace


def traced(tmp_path, fn, warm=None):
    """Run fn() under profiling.trace -> (the span records it added, the
    written trace's events, its baseTimeNanoseconds). warm() runs first
    under a profiler of its own, and a range opens before fn() in the
    trace: a process's first ranges, and a session's first, pay a one-time
    set-up (up to a millisecond, and some 60 us) between the span's clock
    reading and the range's."""
    if warm is not None:
        with torch.profiler.profile():
            warm()
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("warm"):
            pass
        before = len(profiling.spans())
        fn()
    (path,) = tmp_path.glob("trace-*.json")
    doc = json.loads(path.read_text())
    return (profiling.spans()[before:], doc["traceEvents"],
            int(doc.get("baseTimeNanoseconds", 0)))


def one_sorted_step():
    """A train step on the sorted route (K3/K4's plain twins): 200 EWA
    gaussians, one 64x32 view."""
    raw = init_params(torch.Generator().manual_seed(0), 200, 200,
                      use_sh=True, use_quats=True, device="cpu")
    view = tcam.look_at([0.0, 0.3, 2.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        device="cpu")
    proj = tcam.perspective(60.0, 2.0, 0.01, 100.0, device="cpu")
    cams = Camera(view=view[None], proj=proj[None])
    step = make_train_step(
        RenderConfig(width=64, height=32, mode="sorted", footprint="ewa"),
        LossConfig(), has_masks=False, has_depths=False)
    state = init_state(raw, make_optimizer())
    targets = torch.full((1, 32, 64, 3), 0.5)
    return lambda: step(state, cams, targets, None, None)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    rng = np.random.default_rng(0)
    n = 300
    g = make_gaussians(
        rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32),
        rng.uniform(0.02, 0.15, (n, 3)).astype(np.float32),
        rng.uniform(0.2, 0.9, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32), device="cpu")
    path = tmp_path_factory.mktemp("spans") / "scene.npz"
    save_gaussians_npz(path, g)
    return tserve.RenderService(str(path), device="cpu")


def two_clients(svc, frames=2):
    """Two client threads, started now and waiting for the returned run()
    to let them render `frames` frames each; then a frame on this thread."""
    go = threading.Event()

    def client(c):
        go.wait(timeout=60)
        for j in range(frames):
            svc.render_frame(0.3 * c + 0.1 * j, 0.2, 2.5, 128, 48, "sorted")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(2)]
    for t in threads:
        t.start()

    def run():
        go.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        svc.render_frame(0.0, 0.2, 2.5, 128, 48, "sorted")
    return run


@pytest.fixture(scope="module")
def step_trace(tmp_path_factory):
    step = one_sorted_step()
    return traced(tmp_path_factory.mktemp("step"), step, warm=step)


@pytest.fixture(scope="module")
def serve_trace(tmp_path_factory, service):
    return traced(tmp_path_factory.mktemp("serve"), two_clients(service),
                  warm=lambda: service.render_frame(0.0, 0.2, 2.5, 128, 48,
                                                    "sorted"))


def test_annotate_is_free_when_no_profiler_runs():
    before = len(profiling.spans())
    off = profiling.annotate("gs.stage")
    assert off is profiling.annotate("gs.fit.step", root=True)
    with off, profiling.annotate("gs.binner"):
        torch.ones(4).sum()
    one_sorted_step()()
    assert len(profiling.spans()) == before


def test_a_sorted_step_records_its_spans_under_one_root(step_trace):
    records, _, _ = step_trace
    names = {r.name for r in records}
    assert set(STEP_SPANS) <= names
    (root,) = [r for r in records if r.name == "gs.fit.step"]
    assert root.root == root.id and root.parent is None
    assert all(r.root == root.id for r in records)
    (bwd,) = [r for r in records if r.name == "gs.fit.backward"]
    assert bwd.parent == root.id
    (comp,) = [r for r in records if r.name == "gs.composite.bwd"]
    assert comp.parent == bwd.id
    assert bwd.start_ns <= comp.start_ns <= comp.end_ns <= bwd.end_ns
    by_id = {r.id: r for r in records}
    for r in records:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.thread == r.thread
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns


def test_two_clients_record_a_wait_and_a_render_per_frame(serve_trace):
    records, _, _ = serve_trace
    frames = [r for r in records if r.name == "gs.serve.frame"]
    assert len(frames) == 5 and len({r.thread for r in frames}) == 3
    for f in frames:
        assert f.root == f.id and f.parent is None
        kids = sorted((r for r in records if r.parent == f.id),
                      key=lambda r: r.start_ns)
        assert [k.name for k in kids] == ["gs.serve.lock_wait",
                                          "gs.serve.render"]
        assert all(k.root == f.id and k.thread == f.thread for k in kids)
        assert kids[0].end_ns <= kids[1].start_ns
        stage = [r for r in records if r.parent == kids[1].id]
        assert [r.name for r in stage][:1] == ["gs.stage"]


@pytest.mark.parametrize("which", ["step", "serve"])
def test_records_lie_on_the_chrome_trace_clock(which, step_trace,
                                               serve_trace):
    """Each span of this thread against its range in the written trace,
    the trace's `ts` plus baseTimeNanoseconds. A record's clock readings
    bracket its range's `record_function`, so on one clock the range lies
    inside the record. Its own ends take some 10 us each and more when the
    host preempts the thread, so each range must lie inside its record to
    CLOCK_US, and the offset between the clocks, pinned by every span
    between the latest end of a range after its record's end and the
    earliest start of a range after its record's start, within CLOCK_US.
    (A profiler records ranges on the thread that started it and on the
    autograd engine's threads, which inherit its state: the client
    threads' spans are in the buffer alone.)"""
    records, events, base_ns = step_trace if which == "step" else serve_trace
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"] + base_ns / 1e3, e["ts"] + e["dur"] + base_ns / 1e3))
    mine = [r for r in records if r.thread == threading.get_ident()]
    assert {r.name for r in mine} >= (
        set(STEP_SPANS) if which == "step" else
        {"gs.serve.frame", "gs.serve.lock_wait", "gs.serve.render",
         "gs.stage", "gs.binner", "gs.composite.fwd"})
    lo, hi = -float("inf"), float("inf")
    for r in mine:
        t0, t1 = r.start_ns / 1e3, r.end_ns / 1e3
        a, b = min(ranges[r.name],
                   key=lambda ab: max(abs(ab[0] - t0), abs(ab[1] - t1)))
        assert a > t0 - CLOCK_US and b < t1 + CLOCK_US, (r.name, a - t0,
                                                         t1 - b)
        lo, hi = max(lo, b - t1), min(hi, a - t0)
    assert -CLOCK_US < lo <= hi < CLOCK_US, (lo, hi)


def test_spans_of_many_threads_keep_their_roots(tmp_path):
    """Eight threads, each a root with nested spans, switching as often as
    the interpreter allows: every record keeps its own thread's root and
    parent, and none is lost."""
    def work():
        for _ in range(50):
            with profiling.annotate("t.root", root=True):
                with profiling.annotate("t.mid"):
                    with profiling.annotate("t.leaf"):
                        pass

    def run():
        threads = [threading.Thread(target=work) for _ in range(8)]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)

    records, _, _ = traced(tmp_path, run)
    assert len(records) == 8 * 50 * 3
    by_id = {r.id: r for r in records}
    for r in records:
        if r.name == "t.root":
            assert r.root == r.id and r.parent is None
        else:
            p = by_id[r.parent]
            assert p.thread == r.thread and r.root == p.root
            assert p.name == ("t.root" if r.name == "t.mid" else "t.mid")

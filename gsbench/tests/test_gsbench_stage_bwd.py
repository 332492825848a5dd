"""The reader of stage_bwd_ms.fit: None on a trace without the span
`gs.stage.bwd` (a program whose stage backward is autograd's own nodes),
the device time launched inside it a step where the span is there, and
None off the fit cells."""

import pytest

from gsbench import harness
from gsbench.tests.tiny import REPO


def reader():
    return harness.load_module(
        REPO / "gsbench" / "metrics" / "stage_bwd_ms.fit.py",
        "r_stage_bwd_ms_fit")


def test_none_without_the_span_then_its_device_time():
    node = ("autograd::engine::evaluate_function: MulBackward0",)
    facts = {"kind": "fit", "b": {"calls": 2, "device": [
        ("elementwise_kernel", 2e-3, node),
        ("stage_fwd_kernel", 1e-3, ("gs.fit.step", "gs.stage"))]}}
    assert reader().read(facts) is None
    facts["b"]["device"].append(
        ("stage_bwd_kernel", 1e-3,
         ("autograd::engine::evaluate_function: _StageBackward",
          "gs.stage.bwd")))
    assert reader().read(facts) == pytest.approx(0.5)
    assert reader().read(dict(facts, kind="serve")) is None

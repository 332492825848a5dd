"""Port parity, the host-side utilities: `cli.make_cameras` and `cli.view`
(tests/test_cli.py's mirrors), `utils.debug` and `utils.profiling`
against `tpu_gaussians`' (CPU).

make_cameras writes the JAX CLI's rig (look_at in each package's float32
arithmetic: atol 1e-6). StepTimer gives JAX's EMA exactly on the same
ticks. On the CPU a trace has no device track, so the device-time readers
return [], as JAX's do."""

import json

import numpy as np
import pytest
import torch

from tpu_gaussians.cli import make_cameras as jmake_cameras
from tpu_gaussians.utils import debug as jdebug
from tpu_gaussians.utils import profiling as jprofiling
from tpu_gaussians_torch.cli import make_cameras as tmake_cameras
from tpu_gaussians_torch.cli import view as tview
from tpu_gaussians_torch.core.camera import load_cameras_npz
from tpu_gaussians_torch.core.types import gaussians_from_numpy
from tpu_gaussians_torch.fit.step import init_state, make_optimizer
from tpu_gaussians_torch.io.npz import save_gaussians_npz
from tpu_gaussians_torch.kernels import splat_sep
from tpu_gaussians_torch.models.gaussian_model import init_params
from tpu_gaussians_torch.utils import debug as tdebug
from tpu_gaussians_torch.utils import profiling as tprofiling


def test_make_cameras_cli(tmp_path, capsys):
    argv = ["--num_views", "5", "--width", "64", "--height", "48",
            "--pitch", "0.3"]
    tmake_cameras.main([str(tmp_path / "t.npz")] + argv)
    jmake_cameras.main([str(tmp_path / "j.npz")] + argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("t.npz", "j.npz") == out[1]
    cams = load_cameras_npz(tmp_path / "t.npz", expected_views=5,
                            device="cpu")
    assert cams.view.shape == (5, 4, 4)
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    for k in ("view", "proj"):
        assert t[k].dtype == j[k].dtype == np.float32
        np.testing.assert_allclose(t[k], j[k], atol=1e-6)


@pytest.mark.parametrize("sh", [False, True], ids=["rgb", "sh"])
def test_view_cli_save(tmp_path, sh):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    arr = dict(means=rng.uniform(-0.6, 0.6, (20, 3)),
               scales=rng.uniform(0.02, 0.25, (20, 3)),
               opacities=rng.uniform(0.05, 0.95, 20))
    if sh:
        arr["sh"] = rng.uniform(0, 1, (20, 4, 3))
    else:
        arr["colors"] = rng.uniform(0, 1, (20, 3))
    save_gaussians_npz(tmp_path / "m.npz", gaussians_from_numpy(
        {k: v.astype(np.float32) for k, v in arr.items()}, device="cpu"))
    out = tmp_path / "scatter.png"
    tview.main([str(tmp_path / "m.npz"), "--save", str(out),
                "--max_points", "10"])
    assert out.exists() and out.stat().st_size > 0


def test_assert_finite_over_trees():
    raw = init_params(torch.Generator().manual_seed(0), 10, 16, use_sh=True,
                      device="cpu")
    state = init_state(raw, make_optimizer())
    tdebug.assert_finite(raw, "raw")
    tdebug.assert_finite(state, "state")
    tdebug.assert_finite({"a": torch.ones(3), "b": [np.zeros(2), 1.0]})
    bad = {"b": torch.tensor([1.0, float("inf")]), "a": torch.ones(3)}
    with pytest.raises(FloatingPointError) as t_err:
        tdebug.assert_finite(bad, "grads")
    with pytest.raises(FloatingPointError) as j_err:
        jdebug.assert_finite({k: v.numpy() for k, v in bad.items()},
                             "grads")
    assert str(t_err.value) == str(j_err.value) == \
        "non-finite values in grads[leaf 1]"
    with pytest.raises(FloatingPointError):
        tdebug.assert_finite(raw.replace(means=raw.means * float("nan")))


def test_determinism_check():
    x = torch.arange(12.0).reshape(3, 4)
    assert tdebug.determinism_check(lambda a: {"y": a * 2, "z": [a.sum()]},
                                    x)
    gen = torch.Generator().manual_seed(0)
    assert not tdebug.determinism_check(
        lambda a: a + torch.rand(a.shape, generator=gen), x)
    # bitwise, not by value: -0.0 == 0.0 but differs in its bits
    flips = iter([torch.tensor([0.0]), torch.tensor([-0.0])])
    assert not tdebug.determinism_check(lambda: next(flips))


def test_interpret_mode_on_cpu_runs_the_twin():
    """On CPU tensors a wrapper runs its twin in and out of the mode; the
    mode nests and always unwinds."""
    from tpu_gaussians_torch.kernels import build

    lo = torch.zeros(1, dtype=torch.int32)
    cnt = torch.zeros(1, dtype=torch.int32)
    gdata = torch.zeros((128, 16))
    before = dict(splat_sep.launches)
    with tdebug.interpret_mode():
        with tdebug.interpret_mode():
            assert build.interpret_depth == 2
        acc = splat_sep.splat_sep_fwd(lo, cnt, gdata, 64, 128, 128)
    assert build.interpret_depth == 0
    assert splat_sep.launches == before
    assert torch.equal(acc, splat_sep.sep_fwd_plain(lo, cnt, gdata, 64, 128,
                                                    128))
    with pytest.raises(RuntimeError):
        with tdebug.interpret_mode():
            raise RuntimeError("unwinds")
    assert build.interpret_depth == 0


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.5, 1.6, 3.0]
    timers = []
    for mod in (tprofiling, jprofiling):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(pixels_per_step=1000)
        timers.append([(timer.tick(), timer.pixels_per_s) for _ in ticks])
    assert timers[0] == timers[1]
    assert timers[0][0] == (None, None)
    assert tprofiling.StepTimer().pixels_per_s is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(str(tmp_path)):
        with tprofiling.annotate("stage"):
            torch.ones(64).sum()
    (path,) = tmp_path.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "stage" for e in events)
    assert tprofiling.load_trace_events(str(tmp_path)) == []   # no device
    with pytest.raises(FileNotFoundError):
        tprofiling.load_trace_events(str(tmp_path / "none"))
    assert tprofiling.device_program_times_us(
        lambda: torch.ones(8).cumsum(0)) == []

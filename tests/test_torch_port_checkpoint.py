"""Port parity, checkpoints and `--resume`: `tpu_gaussians_torch.io.
checkpoint`, the trainer's `checkpoint_every` / `resume` and
`FitConfig.to_json` / `from_json` (CPU).

Within the port a resumed fit is the unbroken fit bit for bit, a densify
after the resume point included (the checkpoint carries the densify
jitter's generator). Against `tpu_gaussians`' resumed fit (orbax),
densify off and 24x24 as tests/test_checkpoint.py, both resumed from
JAX's checkpoint: the resumed means at its tolerance, rtol 1e-5 / atol
1e-6, with Adam's betas as optax holds them (float32); with the port's
own, plus 1e-5 x lr a step (see the test)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tpu_gaussians.fit import trainer as jtrainer
from tpu_gaussians.core import camera as jcam
from tpu_gaussians.models import gaussian_model as jmodel
from tpu_gaussians.utils import config as jconfig
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.fit import trainer as ttrainer
from tpu_gaussians_torch.fit.step import init_state, make_optimizer
from tpu_gaussians_torch.io.checkpoint import Checkpointer
from tpu_gaussians_torch.models import gaussian_model as tmodel
from tpu_gaussians_torch.utils import config as tconfig

W = H = 24
BASE = dict(iters=20, width=W, height=H, num_gaussians=12, max_gaussians=16,
            densify_interval=1000, prune_interval=1000,
            silhouette_weight=0.0, log_every=1000, seed=3,
            checkpoint_every=10)
BASE_LR = tconfig.FitConfig().lr


def data():
    targets = np.random.default_rng(0).uniform(
        size=(2, H, W, 3)).astype(np.float32)
    return targets, tcam.orbit_cameras(2, W, H, device="cpu")


def trained_state(steps=3):
    """A TrainState after `steps` Adam steps on random gradients, so that
    Adam's moments and step counts are non-trivial."""
    tx = make_optimizer(0.02)
    raw = tmodel.init_params(torch.Generator().manual_seed(0), 10, 16,
                             use_sh=True, device="cpu")
    state = init_state(raw, tx)
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        for t in state.raw.trainable().values():
            t.grad = torch.randn(t.shape, generator=gen)
        state.opt.step()
        state.grad_norm_accum += 1.5
        state.grad_steps += 1
    return tx, state


def test_save_restore_roundtrip(tmp_path):
    tx, state = trained_state()
    gen = torch.Generator().manual_seed(42)
    torch.randn(5, generator=gen)      # its state, not its seed, is saved
    ckpt = Checkpointer(tmp_path / "ckpts")
    ckpt.save(7, state, gen)
    assert ckpt.latest_step() == 7
    step, restored, gen_state = ckpt.restore(tx, "cpu")
    assert step == 7
    for k, t in state.raw.trainable().items():
        r = restored.raw.trainable()[k]
        assert torch.equal(r, t) and r.requires_grad and r.is_leaf
    assert torch.equal(restored.raw.alive, state.raw.alive)
    assert torch.equal(restored.grad_norm_accum, state.grad_norm_accum)
    assert torch.equal(restored.grad_steps, state.grad_steps)
    assert torch.equal(gen_state, gen.get_state())
    saved, got = state.opt.state_dict(), restored.opt.state_dict()
    assert saved["param_groups"] == got["param_groups"]
    for i, s in saved["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][k], s[k])


def test_retention_keeps_the_latest_three(tmp_path):
    tx, state = trained_state(1)
    ckpt = Checkpointer(tmp_path)
    for step in (10, 20, 30, 40, 50):
        ckpt.save(step, state, torch.Generator())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["30", "40", "50"]
    assert ckpt.steps() == [30, 40, 50] and ckpt.latest_step() == 50
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(tx, "cpu")


def test_resumed_fit_equals_unbroken_bit_for_bit(tmp_path, capsys):
    """20 iterations unbroken against 10 + a resume to 20, with a densify
    at 15 (after the resume point, its jitter from the restored
    generator): the same parameters bit for bit; the resumed fit reports
    only its own steps, appends them to metrics.jsonl, and keeps the
    checkpoints at 10 and 20."""
    targets, cams = data()
    cfg = tconfig.FitConfig(**{**BASE, "densify_interval": 15,
                               "prune_interval": 15})
    full = ttrainer.fit(cfg, targets, cams, out_dir=tmp_path / "full",
                        device="cpu")
    out = tmp_path / "resumed"
    ttrainer.fit(dataclasses.replace(cfg, iters=10), targets, cams,
                 out_dir=out, device="cpu")
    capsys.readouterr()
    res = ttrainer.fit(dataclasses.replace(cfg, resume=True), targets, cams,
                       out_dir=out, device="cpu")
    assert "Resumed from checkpoint at iter 10" in capsys.readouterr().out
    for k, t in full.raw.trainable().items():
        assert torch.equal(getattr(res.raw, k), t), k
    assert torch.equal(res.raw.alive, full.raw.alive)
    assert int(res.raw.num_alive()) > 12        # the densify at 15 ran
    assert res.loss_log == full.loss_log[10:]
    steps = [json.loads(line)["step"] for line in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert steps == list(range(1, 21))
    full_rows = (tmp_path / "full" / "metrics.jsonl").read_text()
    assert (out / "metrics.jsonl").read_text() == full_rows
    assert Checkpointer(out / "checkpoints").steps() == [10, 20]


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    targets, cams = data()
    cfg = tconfig.FitConfig(**{**BASE, "iters": 4, "resume": True})
    res = ttrainer.fit(cfg, targets, cams, out_dir=tmp_path, device="cpu")
    assert len(res.loss_log) == 4
    assert Checkpointer(tmp_path / "checkpoints").steps() == []


def test_checkpoint_every_without_out_dir_runs():
    """JAX's trainer runs checkpoint_every > 0 (and resume) without an
    out_dir and writes no checkpoint; so does the port."""
    targets, cams = data()
    for kw in (dict(checkpoint_every=2), dict(resume=True)):
        cfg = tconfig.FitConfig(**{**BASE, "iters": 4, **kw})
        res = ttrainer.fit(cfg, targets, cams, device="cpu")
        assert len(res.loss_log) == 4


def port_checkpoint(directory, j_state, betas):
    """JAX's TrainState (an orbax restore) saved as the port's checkpoint
    at step 10: its params, Adam's moments and count, grad stats, and an
    Adam with these betas (a restore keeps a checkpoint's param groups)."""
    raw = tmodel.raw_from_numpy(
        {f: np.asarray(getattr(j_state.raw, f)) for f in tmodel.LEAVES
         if getattr(j_state.raw, f) is not None}, device="cpu")
    state = init_state(raw, make_optimizer(BASE_LR))
    for group in state.opt.param_groups:
        group["betas"] = betas
    adam = j_state.opt_state[0]      # optax.adam: (ScaleByAdamState, ...)
    for k, p in state.raw.trainable().items():
        state.opt.state[p] = {
            "step": torch.tensor(float(adam.count)),
            "exp_avg": torch.from_numpy(np.array(adam.mu[k])),
            "exp_avg_sq": torch.from_numpy(np.array(adam.nu[k]))}
    state.grad_norm_accum.copy_(torch.from_numpy(np.array(
        j_state.grad_norm_accum)))
    state.grad_steps.fill_(int(j_state.grad_steps))
    Checkpointer(directory / "checkpoints").save(10, state,
                                                 torch.Generator())


def test_resumed_fit_matches_jax_resumed_fit(tmp_path):
    """tests/test_checkpoint.py's interrupted fit (10 of 20 iterations) in
    JAX; its orbax checkpoint at 10 carried into the port's format; both
    packages resume to 20.

    optax holds Adam's betas as float32 (f32(0.999) = 0.999 + 1.3e-8), so
    its 1 - 0.999^t is off by 1.3e-5 relative at every t and its updates
    by ~6.5e-6 relative; the port's Adam computes with the exact constants
    (test_torch_port_fit's Adam test holds it to a float64 Adam). With the
    betas optax holds, the port's resumed means are JAX's at
    test_checkpoint's tolerance, rtol 1e-5 / atol 1e-6. With its own,
    they stay within rtol 1e-5 plus 1e-5 x lr a resumed step (2e-6 here;
    a run on the CPU measured 1.6e-6). From step 0 the two packages' fits
    differ more (3.2e-6): optax's f32 pow adds up to 6e-5/t relative in
    the first steps."""
    pytest.importorskip("orbax.checkpoint")
    from tpu_gaussians.fit import step as jstep
    from tpu_gaussians.io.checkpoint import Checkpointer as JCheckpointer

    targets, t_cams = data()
    j_cams = jcam.orbit_cameras(2, W, H)
    j_cfg = jconfig.FitConfig(**BASE, impl="jnp")
    jtrainer.fit(dataclasses.replace(j_cfg, iters=10), targets, j_cams,
                 out_dir=tmp_path / "j")
    _, k_init = jax.random.split(jax.random.PRNGKey(BASE["seed"]))
    raw0 = jmodel.init_params(k_init, BASE["num_gaussians"],
                              BASE["max_gaussians"])
    step, j_state, _ = JCheckpointer(tmp_path / "j" / "checkpoints").restore(
        jstep.init_state(raw0, jstep.make_optimizer(j_cfg.lr)),
        jax.random.PRNGKey(0))
    assert step == 10
    j_res = jtrainer.fit(dataclasses.replace(j_cfg, resume=True), targets,
                         j_cams, out_dir=tmp_path / "j")
    j_means = np.asarray(j_res.raw.means)

    t_cfg = tconfig.FitConfig(**BASE, impl="torch", resume=True)
    for name, betas, atol in (
            ("optax_betas", (float(np.float32(0.9)),
                             float(np.float32(0.999))), 1e-6),
            ("own_betas", (0.9, 0.999), 10 * BASE_LR * 1e-5)):
        port_checkpoint(tmp_path / name, j_state, betas)
        t_res = ttrainer.fit(t_cfg, targets, t_cams,
                             out_dir=tmp_path / name, device="cpu")
        assert len(t_res.loss_log) == len(j_res.loss_log) == 10
        np.testing.assert_allclose(t_res.loss_log, j_res.loss_log,
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(t_res.raw.means.numpy(), j_means,
                                   rtol=1e-5, atol=atol, err_msg=name)


def test_fit_config_json_roundtrip():
    cfg = tconfig.FitConfig(iters=7, use_sh=True, footprint="ewa",
                            checkpoint_every=5, resume=True)
    text = cfg.to_json()
    assert tconfig.FitConfig.from_json(text) == cfg
    j = jconfig.FitConfig(iters=7, use_sh=True, footprint="ewa",
                          checkpoint_every=5, resume=True)
    assert json.loads(text) == json.loads(j.to_json())
    assert tconfig.FitConfig.from_json(j.to_json()) == cfg

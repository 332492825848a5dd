"""Port parity, the training path: `tpu_gaussians_torch`'s model, loss,
Adam, densify/prune, trainer and fit CLI against `tpu_gaussians`' on
identical numpy inputs (CPU; the JAX side's kernels in interpret mode).

Tolerances: loss value and gradients rtol 5e-4 / atol 1e-5 (the JAX
suite's end-to-end grad check, tests/test_pallas_parity.py:83-103); Adam
rtol 1e-6 against a float64 Adam and optax (see the test for optax's
f32 bias corrections);
densify/prune masks and counts exact, floats rtol 1e-6 / atol 1e-7; the
20-iteration fit's loss curve rtol 1e-3 and its final N exact."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_gaussians.cli import fit as jfit_cli
from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.fit import densify as jdensify
from tpu_gaussians.fit import loss as jloss
from tpu_gaussians.fit import step as jstep
from tpu_gaussians.fit import trainer as jtrainer
from tpu_gaussians.models import gaussian_model as jmodel
from tpu_gaussians.utils import config as jconfig
from tpu_gaussians_torch.cli import fit as tfit_cli
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core import types as ttypes
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.fit import densify as tdensify
from tpu_gaussians_torch.fit import loss as tloss
from tpu_gaussians_torch.fit import step as tstep
from tpu_gaussians_torch.fit import trainer as ttrainer
from tpu_gaussians_torch.models import gaussian_model as tmodel
from tpu_gaussians_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parent.parent
SCENE = ROOT / "assets" / "example_scene"


def arrays_of(raw_j):
    """A JAX RawParams' leaves as numpy arrays."""
    return {f: np.asarray(getattr(raw_j, f)) for f in tmodel.LEAVES
            if getattr(raw_j, f) is not None}


def random_raw(c, n, seed, sh=True, op_range=(-3.0, 3.0),
               scale_range=(-3.0, -1.5)):
    """Raw leaves: rows [0, n) alive with random values, the rest dead."""
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (c, 3)),
        scales_raw=rng.uniform(*scale_range, (c, 3)),
        opacities_raw=rng.uniform(*op_range, c),
        alive=(np.arange(c) < n).astype(np.float32))
    if sh:
        sh_raw = rng.normal(0.0, 0.15, (c, 4, 3))
        sh_raw[:, 0] = rng.uniform(0.0, 1.0, (c, 3))
        arr["sh_raw"] = sh_raw
    else:
        arr["colors_raw"] = rng.normal(0.0, 1.0, (c, 3))
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    return jmodel.RawParams(**{k: jnp.asarray(v) for k, v in arr.items()}), \
        tmodel.raw_from_numpy(arr, device="cpu")


def test_config_matches_jax():
    j_fields = {f.name: f.default for f in dataclasses.fields(
        jconfig.FitConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(
        tconfig.FitConfig)}
    assert t_fields == j_fields
    assert tconfig.SORTED_EWA_MIN_CAPACITY == jconfig.SORTED_EWA_MIN_CAPACITY
    for mode in ("auto", "accum", "sorted"):
        for footprint in ("axis", "ewa"):
            for cap in (3000, 4096):
                kw = dict(render_mode=mode, footprint=footprint)
                assert tconfig.resolve_render_mode(
                    tconfig.FitConfig(**kw), cap) == \
                    jconfig.resolve_render_mode(jconfig.FitConfig(**kw), cap)


@pytest.mark.parametrize("use_sh", [False, True])
def test_model_init_and_activation(use_sh):
    gen = torch.Generator().manual_seed(0)
    raw = tmodel.init_params(gen, 100, 160, use_sh=use_sh, device="cpu")
    j_raw = jmodel.init_params(jax.random.PRNGKey(0), 100, 160,
                               use_sh=use_sh)
    for f in tmodel.LEAVES:           # same shapes and the same constants
        t, j = getattr(raw, f), getattr(j_raw, f)
        assert (t is None) == (j is None)
        if t is not None:
            assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_array_equal(raw.alive.numpy(), np.asarray(j_raw.alive))
    np.testing.assert_array_equal(raw.scales_raw.numpy(),
                                  np.asarray(j_raw.scales_raw))
    assert float(raw.means[:100].abs().max()) <= 0.6
    assert not raw.means[100:].any()

    j_raw, t_raw = random_raw(64, 50, 1, sh=use_sh)
    j_g, t_g = jmodel.activate(j_raw), tmodel.activate(t_raw)
    for f in ("means", "scales", "opacities", "colors", "sh", "alive"):
        j, t = getattr(j_g, f), getattr(t_g, f)
        assert (j is None) == (t is None)
        if t is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    back = tmodel.raw_from_gaussians(t_g, capacity=80)
    j_back = jmodel.raw_from_gaussians(j_g, capacity=80)
    for f, j in arrays_of(j_back).items():
        np.testing.assert_allclose(getattr(back, f).numpy(), j, rtol=1e-5,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("impl", ["tiled", "torch"])
def test_loss_and_grads_match_jax(impl):
    v, w, h = 3, 64, 64
    j_raw, t_raw = random_raw(320, 300, 2)
    rng = np.random.default_rng(3)
    targets = rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)
    masks = (targets.mean(axis=3) > 0.5).astype(np.float32)
    depths = rng.uniform(0, 1, (v, h, w)).astype(np.float32)
    lcfg = dict(ssim_weight=0.2)
    rkw = dict(width=w, height=h, mode="accum", return_aux=True,
               chunk_size=64)
    j_cams = jcam.orbit_cameras(v, w, h)
    j_cfg = JConfig(impl="pallas" if impl == "tiled" else "jnp", **rkw)

    def f(tr):
        return jloss.loss_fn(j_raw.with_trainable(tr), j_cams, targets, masks,
                             depths, j_cfg, jloss.LossConfig(**lcfg))

    (j_loss, j_metrics), j_grads = jax.value_and_grad(f, has_aux=True)(
        j_raw.trainable())

    leaves = {k: t.clone().requires_grad_(True)
              for k, t in t_raw.trainable().items()}
    t_loss, t_metrics = tloss.loss_fn(
        t_raw.with_trainable(leaves), tcam.orbit_cameras(v, w, h, device="cpu"),
        torch.from_numpy(targets), torch.from_numpy(masks),
        torch.from_numpy(depths), TConfig(impl=impl, **rkw),
        tloss.LossConfig(**lcfg))
    t_loss.backward()
    assert set(t_metrics) == set(j_metrics)
    for k, j in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(j), rtol=5e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=5e-4)
    for k, j in j_grads.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(j),
                                   rtol=5e-4, atol=1e-5, err_msg=f"grad {k}")


def test_adam_and_reset_match_optax():
    """Three steps, the third after a reset, means at half the lr. Against
    a float64 Adam the port holds rtol 1e-6 / atol 1e-8. optax rounds its
    bias corrections to f32: 1 - f32(0.999)^t is off by up to ~6e-5/t
    relative (1.3e-5 at t = 1), ~3e-5/t in the update, so against optax
    the bound adds 5e-5 of the update's size (lr * scale) over the run."""
    j_raw, t_raw = random_raw(96, 80, 4)
    rng = np.random.default_rng(5)
    grads = [{k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
              for k, v in j_raw.trainable().items()} for _ in range(3)]
    lr = {k: 0.02 * (0.5 if k == "means" else 1.0) for k in grads[0]}
    tx_j = jstep.make_optimizer(0.02)
    params_j, opt_j = j_raw.trainable(), tx_j.init(j_raw.trainable())
    tx_t = tstep.make_optimizer(0.02)
    state = tstep.init_state(t_raw, tx_t)
    exact = {k: np.asarray(v, np.float64) for k, v in params_j.items()}
    m = {k: 0.0 for k in exact}
    v = {k: 0.0 for k in exact}
    t = 0
    for i, g in enumerate(grads):
        if i == 2:    # the reset a densify event makes: fresh moments
            opt_j = tx_j.init(params_j)
            m, v, t = {k: 0.0 for k in m}, {k: 0.0 for k in v}, 0
            state.grad_norm_accum += 1.0
            state = tstep.reset_optimizer(state, tx_t)
            assert not state.grad_norm_accum.any()
            assert int(state.grad_steps) == 0 and not state.opt.state
        updates, opt_j = tx_j.update(g, opt_j, params_j)
        updates = dict(updates)
        updates["means"] = updates["means"] * 0.5
        params_j = optax.apply_updates(params_j, updates)
        t += 1
        for k in exact:
            g64 = g[k].astype(np.float64)
            m[k] = 0.9 * m[k] + 0.1 * g64
            v[k] = 0.999 * v[k] + 0.001 * g64 * g64
            exact[k] = exact[k] - lr[k] * (m[k] / (1 - 0.9 ** t)) / (
                np.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
        for k, p in state.raw.trainable().items():
            p.grad = torch.from_numpy(g[k])
        tstep.adam_update(state, means_lr_scale=0.5)
        for k, j in params_j.items():
            p = state.raw.trainable()[k].detach().numpy()
            np.testing.assert_allclose(p, exact[k], rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {i}: {k} vs float64")
            np.testing.assert_allclose(p, np.asarray(j), rtol=1e-6,
                                       atol=5e-5 * lr[k],
                                       err_msg=f"step {i}: {k} vs optax")


DENSIFY_CASES = {
    "opacity": dict(c=256, n=150, ratio=0.15),
    "floor": dict(c=256, n=150, ratio=0.15, op_range=(-6.0, -3.5)),
    "grad_split": dict(c=256, n=150, ratio=0.3, metric="grad", split=0.1,
                       scale_range=(-4.0, 0.0)),
    "split_opacity": dict(c=256, n=150, ratio=0.5, split=0.1,
                          scale_range=(-4.0, 0.0)),
    "full": dict(c=200, n=200, ratio=0.15),
    "prune_only": dict(c=256, n=150, ratio=0.0),
}


@pytest.mark.parametrize("case", sorted(DENSIFY_CASES))
def test_densify_and_prune_matches_jax(case):
    kw = dict(DENSIFY_CASES[case])
    c, n = kw.pop("c"), kw.pop("n")
    ratio, metric = kw.pop("ratio"), kw.pop("metric", "opacity")
    split = kw.pop("split", 0.0)
    j_raw, t_raw = random_raw(c, n, 6, **kw)
    rng = np.random.default_rng(7)
    gacc = rng.uniform(0, 1, c).astype(np.float32)
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.normal(key, (c, 3), jnp.float32))
    j_cfg = jdensify.DensifyConfig(clone_metric=metric,
                                   split_scale_thresh=split)
    t_cfg = tdensify.DensifyConfig(clone_metric=metric,
                                   split_scale_thresh=split)
    j_new, j_stats = jdensify.densify_and_prune(
        j_raw, key, j_cfg, densify_ratio=ratio,
        grad_norm_accum=jnp.asarray(gacc), grad_steps=jnp.int32(7))
    t_new, t_stats = tdensify.densify_and_prune(
        t_raw, torch.from_numpy(noise), t_cfg, densify_ratio=ratio,
        grad_norm_accum=torch.from_numpy(gacc),
        grad_steps=torch.tensor(7, dtype=torch.int32))
    assert {k: int(v) for k, v in t_stats.items()} == {
        k: int(v) for k, v in j_stats.items()}
    if case == "floor":
        assert int(t_stats["n_after"]) < 100 and int(t_stats["n_pruned"]) > 0
    if case == "full":
        assert int(t_stats["n_cloned"]) == 0
    for k, j in arrays_of(j_new).items():
        t = getattr(t_new, k).numpy()
        if k == "alive":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7, err_msg=k)


def scene_config(module, **kw):
    return module.FitConfig(
        targets_dir=str(SCENE), camera_npz=str(SCENE / "cameras.npz"),
        iters=20, width=64, height=64, use_sh=True, densify_interval=10,
        prune_interval=10, log_every=10, **kw)


def test_fit_follows_jax_loss_curve(tmp_path):
    """20 iterations on the example scene from the JAX trainer's own initial
    arrays and densify draws (trainer.py:93-94, :303)."""
    j_cfg = scene_config(jconfig, impl="pallas")
    targets, masks, depths, j_cams = jtrainer.load_dataset(j_cfg)
    j_res = jtrainer.fit(j_cfg, targets, j_cams, masks=masks, depths=depths)

    key, k_init = jax.random.split(jax.random.PRNGKey(j_cfg.seed))
    raw0 = jmodel.init_params(k_init, j_cfg.num_gaussians, j_cfg.max_gaussians,
                              use_sh=True)
    noise = {}
    for it in (10, 20):
        key, k_d = jax.random.split(key)
        noise[it] = torch.from_numpy(np.array(jax.random.normal(
            k_d, (j_cfg.max_gaussians, 3), jnp.float32)))

    t_cfg = scene_config(tconfig, impl="tiled")
    t_targets, t_masks, t_depths, t_cams = ttrainer.load_dataset(
        t_cfg, device="cpu")
    np.testing.assert_array_equal(t_targets, targets)
    np.testing.assert_array_equal(t_masks, masks)
    t_res = ttrainer.fit(t_cfg, t_targets, t_cams, masks=t_masks,
                         depths=t_depths, out_dir=tmp_path, device="cpu",
                         raw0=tmodel.raw_from_numpy(arrays_of(raw0), "cpu"),
                         densify_noise=noise.__getitem__)
    ttrainer.write_artifacts(tmp_path, t_res, t_cfg)

    assert len(t_res.loss_log) == len(j_res.loss_log) == 20
    np.testing.assert_allclose(t_res.loss_log, j_res.loss_log, rtol=1e-3)
    n_metric = [float(line.split('"n_alive": ')[1].split(",")[0]) for line in
                (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert n_metric[0] == 800 and n_metric[-1] == 920
    assert int(t_res.raw.num_alive()) == int(j_res.raw.num_alive())
    for name in ("gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                 "preview_view0.png"):
        assert (tmp_path / name).stat().st_size > 0
    assert len((tmp_path / "loss.txt").read_text().splitlines()) == 20


def test_fit_cli_flags_and_main(tmp_path):
    j_ap, t_ap = jfit_cli.build_parser(), tfit_cli.build_parser()

    def options(ap):
        return {s: a.default for a in ap._actions for s in a.option_strings}

    j_opts, t_opts = options(j_ap), options(t_ap)
    assert set(t_opts) == set(j_opts) | {"--device"}
    assert {k: v for k, v in t_opts.items() if k != "--device"} == j_opts
    assert t_opts["--device"] == "cuda"
    impl = next(a for a in t_ap._actions if "--impl" in a.option_strings)
    assert impl.choices == ["auto", "torch", "tiled"]

    out = tmp_path / "fit"
    tfit_cli.main(["--targets_dir", str(SCENE), "--camera_npz",
                   str(SCENE / "cameras.npz"), "--iters", "3", "--width",
                   "32", "--height", "32", "--use_sh", "--out_dir", str(out),
                   "--device", "cpu"])
    for name in ("gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                 "preview_view0.png"):
        assert (out / name).exists()
    assert len((out / "loss.txt").read_text().splitlines()) == 3


def test_fit_refuses_unported_options_and_missing_card():
    targets = np.zeros((1, 16, 16, 3), np.float32)
    cams = tcam.orbit_cameras(1, 16, 16, device="cpu")
    cfg = tconfig.FitConfig(width=16, height=16, iters=1, num_gaussians=10,
                            max_gaussians=16, num_view_shards=2)
    # JAX's divisibility error, then (two views) no group of two ranks:
    # the error names the launcher, and nothing runs on one process.
    with pytest.raises(ValueError, match="must divide view count 1"):
        ttrainer.fit(cfg, targets, cams, device="cpu")
    with pytest.raises(ValueError, match="must divide view count 1"):
        jtrainer.fit(jconfig.FitConfig(
            width=16, height=16, iters=1, num_gaussians=10,
            max_gaussians=16, num_view_shards=2, impl="jnp"), targets,
            jcam.orbit_cameras(1, 16, 16))
    with pytest.raises(RuntimeError, match="torch.distributed.run "
                       "--nproc_per_node 2 -m tpu_gaussians_torch.cli.fit"):
        ttrainer.fit(cfg, np.zeros((2, 16, 16, 3), np.float32),
                     tcam.orbit_cameras(2, 16, 16, device="cpu"),
                     device="cpu")
    # the axis footprint's binned kernels (K7) are ported: it trains
    cfg = tconfig.FitConfig(width=16, height=16, iters=1, num_gaussians=10,
                            max_gaussians=16, accum_binned="on")
    assert np.isfinite(ttrainer.fit(cfg, targets, cams,
                                    device="cpu").loss_log).all()
    if not torch.cuda.is_available():
        cfg = tconfig.FitConfig(width=16, height=16, iters=1)
        with pytest.raises(RuntimeError, match="cuda"):
            ttrainer.fit(cfg, targets, cams, device="cuda")


def test_resolve_device_turns_tf32_off_for_convolutions(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert ttypes.resolve_device("cuda").type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_fit_help_states_the_accum_binned_rule(capsys):
    """`--help` names the rule `ops/dispatch.uses_binned_accum` applies:
    under auto, EWA bins at n >= BINNED_MIN_N and the axis footprint
    never; off is the dense band kernels, on the tile-binned lists."""
    from tpu_gaussians_torch.ops.binned import BINNED_MIN_N
    from tpu_gaussians_torch.ops.dispatch import uses_binned_accum

    with pytest.raises(SystemExit):
        tfit_cli.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert (f"auto = tile-binned lists for the ewa footprint at n >= "
            f"{BINNED_MIN_N} gaussians, dense band kernels below it and "
            "always for the axis footprint; off = dense band kernels; on = "
            "tile-binned lists") in text
    for footprint, n, binned in (("ewa", BINNED_MIN_N, True),
                                 ("ewa", BINNED_MIN_N - 1, False),
                                 ("axis", 10 ** 7, False)):
        for mode, want in (("auto", binned), ("off", False), ("on", True)):
            cfg = TConfig(footprint=footprint, accum_binned=mode)
            assert uses_binned_accum(cfg, n) == want

"""Port parity, sorted training and the EWA accumulation forward (slice 3):
`tpu_gaussians_torch`'s `auto_pair_k`, the EWA sorted fit, the depth aux of
the sorted path, K5's plain twin and render(mode="accum", footprint="ewa")
against `tpu_gaussians` (its Pallas kernels in interpret mode on the CPU)
on identical numpy inputs; and the trainer's up-front refusal.

Tolerances: the fit's loss curve rtol 1e-3 and its N exact (as the
accumulation fit in tests/test_torch_port_fit.py); depth value rtol/atol
1e-4 on covered pixels and gradients rtol 2e-3 / atol 2e-4 times the
largest magnitude (tests/test_sorted_vjp.py:77-120); the K5 forward rtol /
atol 1e-5 (tests/test_pallas_parity.py), sums of positive terms in another
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.fit import trainer as jtrainer
from tpu_gaussians.models import gaussian_model as jmodel
from tpu_gaussians.ops import common as jcommon
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians.ops.pallas import sorted as PS
from tpu_gaussians.ops.pallas import splat as JS
from tpu_gaussians.utils import config as jconfig
from tpu_gaussians_torch.cli import fit as tfit_cli
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.fit import trainer as ttrainer
from tpu_gaussians_torch.kernels import splat_v2
from tpu_gaussians_torch.models import gaussian_model as tmodel
from tpu_gaussians_torch.ops import binning as tbinning
from tpu_gaussians_torch.ops import common as tcommon
from tpu_gaussians_torch.ops import dispatch as tdispatch
from tpu_gaussians_torch.ops import sorted as tsorted
from tpu_gaussians_torch.ops import splat as TS
from tpu_gaussians_torch.utils import config as tconfig

from .test_torch_port_cuda import synthetic_splats
from .test_torch_port_fit import SCENE, arrays_of
from .test_torch_port_render import scene
from .test_torch_port_sorted_bwd import (  # noqa: F401 (autouse fixture)
    assert_grads_close, one_torch_thread)

PAIR_LINE = ("sorted pair budget k=8 (measured max rect, auto; override "
             "with --sorted_pair_k)")


def ewa_config(module, **kw):
    """The EWA fit of the example scene at 64x64: capacity 4096 (auto ->
    sorted), densify/prune every 5 iterations."""
    base = dict(targets_dir=str(SCENE), camera_npz=str(SCENE / "cameras.npz"),
                iters=10, width=64, height=64, use_sh=True,
                max_gaussians=4096, footprint="ewa", densify_interval=5,
                prune_interval=5, log_every=5)
    return module.FitConfig(**{**base, **kw})


@pytest.mark.parametrize("footprint,width,height", [
    ("ewa", 128, 128), ("axis", 512, 256), ("ewa", 512, 256)])
def test_auto_pair_k_matches_jax(footprint, width, height):
    """The fit's 128x128 frame (one tile column) and a 4 x 16-tile frame,
    where the example scene's initial rects reach past K_MIN."""
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    raw = jmodel.init_params(k_init, 800, 4096, use_sh=True,
                             use_quats=footprint == "ewa")
    jc = jcam.load_cameras_npz(str(SCENE / "cameras.npz"), 6)
    tc = tcam.load_cameras_npz(str(SCENE / "cameras.npz"), 6, device="cpu")
    want = PS.auto_pair_k(jmodel.activate(raw), jc.view, jc.proj, width,
                          height, footprint=footprint)
    got = tsorted.auto_pair_k(
        tmodel.activate(tmodel.raw_from_numpy(arrays_of(raw), "cpu")),
        tc.view, tc.proj, width, height, footprint=footprint)
    assert got == want
    if width == 512:
        assert got > tbinning.K_MIN


def test_ewa_sorted_fit_follows_jax(tmp_path, capsys, monkeypatch):
    """10 iterations from the JAX trainer's own initial arrays and densify
    draws (trainer.py:93-94, :303): render_mode auto -> sorted through K3/K4
    (their plain twins here), and the preview through K5's twin."""
    j_cfg = ewa_config(jconfig, impl="pallas")
    targets, masks, depths, j_cams = jtrainer.load_dataset(j_cfg)
    j_res = jtrainer.fit(j_cfg, targets, j_cams, masks=masks, depths=depths)
    j_out = capsys.readouterr().out

    key, k_init = jax.random.split(jax.random.PRNGKey(j_cfg.seed))
    raw0 = jmodel.init_params(k_init, j_cfg.num_gaussians,
                              j_cfg.max_gaussians, use_sh=True,
                              use_quats=True)
    noise = {}
    for it in (5, 10):
        key, k_d = jax.random.split(key)
        noise[it] = torch.from_numpy(np.array(jax.random.normal(
            k_d, (j_cfg.max_gaussians, 3), jnp.float32)))

    v2_calls = []

    def counted_v2_fwd(*args):
        v2_calls.append(args[2].shape)
        return splat_v2.splat_v2_fwd(*args)

    monkeypatch.setattr(TS, "splat_v2_fwd", counted_v2_fwd)
    t_cfg = ewa_config(tconfig, impl="tiled")
    t_targets, t_masks, t_depths, t_cams = ttrainer.load_dataset(
        t_cfg, device="cpu")
    t_res = ttrainer.fit(t_cfg, t_targets, t_cams, masks=t_masks,
                         depths=t_depths, out_dir=tmp_path, device="cpu",
                         raw0=tmodel.raw_from_numpy(arrays_of(raw0), "cpu"),
                         densify_noise=noise.__getitem__)
    assert not v2_calls                      # training is sorted
    ttrainer.write_artifacts(tmp_path, t_res, t_cfg)
    t_out = capsys.readouterr().out

    assert PAIR_LINE in j_out and PAIR_LINE in t_out
    assert len(t_res.loss_log) == len(j_res.loss_log) == 10
    np.testing.assert_allclose(t_res.loss_log, j_res.loss_log, rtol=1e-3)
    n_metric = [float(line.split('"n_alive": ')[1].split(",")[0]) for line in
                (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert n_metric[0] == 800 and n_metric[5] == 920
    assert int(t_res.raw.num_alive()) == int(j_res.raw.num_alive())
    assert v2_calls == [(4096, 16)]          # the preview, through K5
    for name in ("gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                 "preview_view0.png"):
        assert (tmp_path / name).stat().st_size > 0


@pytest.mark.parametrize("footprint,seed,n", [("axis", 2, 48),
                                              ("ewa", 5, 257)])
def test_sorted_depth_value_and_grad_match_jax(footprint, seed, n):
    """The expected-depth aux on covered pixels (alpha > 0.05), in value
    (rtol/atol 1e-4) and gradient (tests/test_sorted_vjp.py:77-120)."""
    w, h = 64, 48
    ewa = footprint == "ewa"
    jg, tg = scene(n, seed, quats=ewa)
    kw = dict(width=w, height=h, mode="sorted", footprint=footprint)
    jc = jcam.orbit_cameras(1, w, h)[0]
    tc = tcam.orbit_cameras(1, w, h, device="cpu")[0]
    j_cfg, t_cfg = JConfig(impl="pallas", **kw), TConfig(impl="tiled", **kw)
    ja, jd = jdispatch.render_sorted(jg, jc.view, jc.proj, j_cfg)[1:]
    covered = (np.asarray(ja) > 0.05).astype(np.float32)
    assert covered.any()
    wd = np.random.default_rng(seed).normal(size=(h, w)).astype(
        np.float32) * covered

    j_grads = jax.grad(lambda g: jnp.sum(jdispatch.render_sorted(
        g, jc.view, jc.proj, j_cfg)[2] * wd))(jg)
    fields = ("means", "scales", "opacities") + (("quats",) if ewa else ())
    for f in fields:
        getattr(tg, f).requires_grad_(True)
    _, _, td = tdispatch.render_sorted(tg, tc.view, tc.proj, t_cfg)
    np.testing.assert_allclose(td.detach().numpy() * covered,
                               np.asarray(jd) * covered, rtol=1e-4,
                               atol=1e-4)
    (td * torch.from_numpy(wd)).sum().backward()
    for f in fields:
        assert_grads_close(getattr(tg, f).grad.numpy(),
                           np.asarray(getattr(j_grads, f)), f"depth {f}")


def ewa_splats(n, height, width, seed):
    """synthetic_splats' columns with a general conic: b drawn so that
    |b| < 0.9 sqrt(a c)."""
    cols = list(synthetic_splats(n, height, width, seed=seed))
    rng = np.random.default_rng(seed + 1)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    return tuple(cols)


# n below SORT_MM_MAX (no y-sort; not a multiple of nb) and above it
# (y-sorted, several bands with a short range each).
V2_CASES = [(1500, 40, 96), (3000, 64, 200)]


@pytest.mark.parametrize("n,height,width", V2_CASES)
def test_v2_twin_and_ewa_accumulation_match_jax(n, height, width):
    cols = ewa_splats(n, height, width, seed=n)
    s = tcommon.SplatInputs(*map(torch.from_numpy, cols[:5]),
                            sigma_x=torch.zeros(n), sigma_y=torch.zeros(n),
                            op_eff=torch.from_numpy(cols[5]),
                            feats=torch.from_numpy(cols[6]))
    lo, cnt, gdata, nb, hw_pad = TS._v2_prep(TS.y_sorted(s), height, width)
    acc8 = splat_v2.v2_fwd_plain(lo, cnt, gdata, hw_pad, width, nb)
    ref8 = JS._fwd_call_v2(jnp.asarray(lo.numpy()[None]),
                           jnp.asarray(cnt.numpy()[None]),
                           jnp.asarray(gdata.numpy().T), hw_pad, width, nb)
    np.testing.assert_allclose(acc8.numpy(), np.asarray(ref8), rtol=1e-5,
                               atol=1e-5)

    before = splat_v2.launches
    with torch.no_grad():
        acc = TS.splat_accumulate(s, height, width, axis=False)
    assert splat_v2.launches == before       # no kernel launched on CPU
    j_s = jcommon_inputs(cols)
    ref = JS.splat_accumulate(j_s, height, width, axis=False)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)

    # differentiable since K6: the gradient reaches px through the y-sort
    s_grad = s._replace(px=s.px.clone().requires_grad_(True))
    TS.splat_accumulate(s_grad, height, width, axis=False).sum().backward()
    assert bool(torch.isfinite(s_grad.px.grad).all())
    assert bool(s_grad.px.grad.any())


def jcommon_inputs(cols):
    px, py, ca, cb, cc, op, feats = map(jnp.asarray, cols)
    zero = jnp.zeros_like(px)
    return jcommon.SplatInputs(px=px, py=py, conic_a=ca, conic_b=cb, conic_c=cc,
                       sigma_x=zero, sigma_y=zero, op_eff=op, feats=feats)


@pytest.mark.parametrize("n", [1200, 2500])
def test_ewa_accum_render_matches_jax(n):
    jg, tg = scene(n, 8, sh=True, quats=True)
    w, h = 96, 72
    kw = dict(width=w, height=h, mode="accum", footprint="ewa",
              return_aux=True, background=(0.1, 0.0, 0.2))
    j_out = jdispatch.render(jg, jcam.orbit_cameras(4, w, h)[2],
                             JConfig(impl="pallas", **kw))
    with torch.no_grad():
        t_out = tdispatch.render(tg, tcam.orbit_cameras(4, w, h,
                                                        device="cpu")[2],
                                 TConfig(impl="tiled", **kw))
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_trainer_refuses_unported_kernels_up_front():
    """Every kernel is ported, so no fit is refused for one: EWA
    accumulation training, dense (K5/K6) or tile-binned (K8), and the axis
    footprint's binned accumulation (K7, accum mode under --accum_binned
    on), tiled or through the plain renderer, each take a step."""
    targets = np.zeros((1, 16, 16, 3), np.float32)
    cams = tcam.orbit_cameras(1, 16, 16, device="cpu")
    for kw in (dict(footprint="ewa"),
               dict(footprint="ewa", max_gaussians=10_240,
                    render_mode="accum"),
               dict(footprint="ewa", accum_binned="on"),
               dict(accum_binned="on", render_mode="sorted"),
               dict(accum_binned="on"),
               dict(accum_binned="on", impl="torch")):
        cfg = tconfig.FitConfig(width=16, height=16, iters=1,
                                num_gaussians=10, **{"max_gaussians": 16,
                                                     **kw})
        res = ttrainer.fit(cfg, targets, cams, device="cpu")
        assert len(res.loss_log) == 1 and np.isfinite(res.loss_log).all()


def test_fit_cli_trains_sorted_with_the_axis_footprint(tmp_path, capsys):
    """--render_mode sorted with the default axis footprint takes K3/K4's
    axis variant (their twins here) through cli.fit."""
    out = tmp_path / "fit"
    tfit_cli.main(["--targets_dir", str(SCENE), "--camera_npz",
                   str(SCENE / "cameras.npz"), "--iters", "3", "--width",
                   "32", "--height", "32", "--use_sh", "--render_mode",
                   "sorted", "--log_every", "1", "--out_dir", str(out),
                   "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "sorted pair budget k=8" in printed
    losses = [float(x) for x in (out / "loss.txt").read_text().splitlines()]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert (out / "preview_view0.png").stat().st_size > 0

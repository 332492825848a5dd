"""Port parity, tile-binned accumulation of the axis footprint (TPU K7):
the separable K7a/K7b twins (`kernels.binned.binned_sep_*_plain`), the
op-folding post-pass, render(mode="accum") under accum_binned "on" with the
axis footprint, and a 6-iteration `--accum_binned on` fit, against
`tpu_gaussians` (its Pallas kernels in interpret mode on the CPU, as the
JAX suite runs them) on identical numpy inputs.

Tolerances:
- K7a's sums: rtol 1e-5 / atol 1e-5 (tests/test_pallas_parity.py:106-113);
- K7b's raw moment rows: rtol 2e-4, and atol 2e-5 times the largest
  magnitude of the output column (at least 2e-5), as K2's and K8b's: the
  moments sum signed terms that cancel;
- the post-pass: rtol 1e-6 / atol 1e-6 (the same O(slots) arithmetic);
- the binned renders (tests/test_binned_accum.py:32-37, 93-96): image and
  alpha rtol 1e-4 / atol 1e-5, depth rtol 1e-3 / atol 1e-4 on covered
  pixels, gradients rtol 2e-3 and atol 2e-4 times the largest magnitude;
  the binner's stats exact;
- the fit: loss curve rtol 1e-3, N exact (tests/test_torch_port_fit.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.fit import trainer as jtrainer
from tpu_gaussians.models import gaussian_model as jmodel
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians.ops.pallas import binned as PB
from tpu_gaussians.utils import config as jconfig
from tpu_gaussians_torch.cli import fit as tfit_cli
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.fit import trainer as ttrainer
from tpu_gaussians_torch.kernels import binned as kbinned
from tpu_gaussians_torch.models import gaussian_model as tmodel
from tpu_gaussians_torch.ops import binned as tbinned
from tpu_gaussians_torch.ops import dispatch as tdispatch
from tpu_gaussians_torch.ops import splat as TS
from tpu_gaussians_torch.utils import config as tconfig

from .test_torch_port_cuda import (CAP, TILES_X, assert_moments_close,
                                   synthetic_lists)
from .test_torch_port_ewa_accum import binned_loss, counted
from .test_torch_port_fit import SCENE, arrays_of
from .test_torch_port_render import scene
from .test_torch_port_sorted_bwd import (  # noqa: F401 (autouse fixture)
    assert_grads_close, one_torch_thread)


@pytest.mark.parametrize("cnt", [(1024, 600, 0, 300), (1, 512, 513, 1024)],
                         ids=["full_partial_empty_short", "chunk_edges"])
def test_sep_twins_match_tpu_kernels(cnt):
    """K7a/K7b twins against _binned_fwd_call / _binned_bwd_call(sep=True)
    on transposed copies of the same axis lists (conic b = 0)."""
    gdense, cnt_t = synthetic_lists(True, cnt=cnt)
    assert not gdense[:, 3].any()
    gd_t, cnt_j = jnp.asarray(gdense.numpy().T), jnp.asarray(
        cnt_t.numpy()[None])
    ref = np.asarray(PB._binned_fwd_call(gd_t, cnt_j, TILES_X, 4,
                                         CAP // PB.NBS, sep=True))
    before = dict(kbinned.launches)
    acc = kbinned.binned_sep_fwd(gdense, cnt_t, TILES_X)
    np.testing.assert_allclose(acc.numpy(), ref, rtol=1e-5, atol=1e-5)
    g8 = np.random.default_rng(4).normal(size=ref.shape).astype(np.float32)
    ref_b = np.asarray(PB._binned_bwd_call(gd_t, cnt_j, jnp.asarray(g8),
                                           TILES_X, 4, CAP // PB.NBS,
                                           sep=True)).T
    out = kbinned.binned_sep_bwd(gdense, cnt_t, torch.from_numpy(g8), TILES_X)
    assert kbinned.launches == before         # no kernel launched on CPU
    assert_moments_close(out.numpy(), ref_b)
    rows = out.reshape(4, CAP, 16)
    for t, c in enumerate(cnt):              # chunks at or past cnt: zero
        assert not rows[t, -(-c // 512) * 512:].any()
        assert not acc.reshape(8, 4, 2048)[:, t].any() or c > 0
    assert not out[:, [3, 5, 14, 15]].any()


def test_sep_wrapper_contract():
    gdense, cnt = synthetic_lists(True)
    g8 = torch.zeros((8, 4 * 2048))
    meta = [t.to("meta") for t in (gdense, cnt)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kbinned.binned_sep_fwd(*meta, TILES_X)
    with pytest.raises(ValueError, match="g8"):
        kbinned.binned_sep_bwd(gdense, cnt, g8[:, :-1], TILES_X)
    with pytest.raises(ValueError):
        kbinned.binned_sep_fwd(gdense[:-16], cnt, TILES_X)
    with pytest.raises(ValueError, match="int32"):
        kbinned.binned_sep_bwd(gdense, cnt.long(), g8, TILES_X)


def test_moment_postpass_opfold_matches_jax():
    rng = np.random.default_rng(5)
    gdense = rng.normal(size=(700, 16)).astype(np.float32)
    raw = rng.normal(size=(700, 16)).astype(np.float32)
    want = np.asarray(PB.moment_postpass_opfold_t(
        jnp.asarray(gdense.T), jnp.asarray(raw.T))).T
    got = tbinned.moment_postpass_opfold(torch.from_numpy(gdense),
                                         torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[:, 3].any() and not got[:, 14:].any()


@pytest.mark.parametrize("n,width,height,knobs", [
    (500, 160, 40, dict()),                       # ragged tiles
    (2000, 128, 48, dict(accum_cull="alpha", accum_tile_capacity=512)),
], ids=["on", "alpha_cap512"])
def test_axis_binned_render_accum_matches_jax(n, width, height, knobs):
    """render_accum values, stats and gradients with the axis footprint
    under accum_binned="on" (K7a/K7b's twins), against JAX's sep=True
    binned path; the second case overflows cap 512."""
    jg, tg = scene(n, 14, sh=True)
    rng = np.random.default_rng(n + 1)
    wi = rng.normal(size=(height, width, 3)).astype(np.float32)
    wa = rng.normal(size=(height, width)).astype(np.float32)
    kw = dict(width=width, height=height, mode="accum", footprint="axis",
              background=(0.1, 0.0, 0.2), accum_binned="on", **knobs)
    assert tdispatch.uses_binned_accum(TConfig(**kw), n)
    jc = jcam.orbit_cameras(4, width, height)[1]
    j_cfg = JConfig(impl="pallas", **kw)
    (_, j_out), j_grads = jax.jit(jax.value_and_grad(binned_loss(
        lambda g, v, p: jdispatch.render_accum(g, v, p, j_cfg,
                                               return_stats=True),
        jnp, jnp.asarray(wi), jnp.asarray(wa)), has_aux=True))(
            jg, jc.view, jc.proj)

    tc = tcam.orbit_cameras(4, width, height, device="cpu")[1]
    t_cfg = TConfig(impl="tiled", **kw)
    fields = ("means", "scales", "opacities", "sh")
    for f in fields:
        getattr(tg, f).requires_grad_(True)
    before = dict(kbinned.launches)
    loss, t_out = binned_loss(
        lambda g, v, p: tdispatch.render_accum(g, v, p, t_cfg,
                                               return_stats=True),
        torch, torch.from_numpy(wi), torch.from_numpy(wa))(
            tg, tc.view, tc.proj)
    loss.backward()
    assert kbinned.launches == before
    assert {k: int(v) for k, v in t_out[3].items()} == {
        k: int(v) for k, v in j_out[3].items()}
    if "accum_tile_capacity" in knobs:
        assert int(t_out[3]["dropped_pairs"]) > 0
    ti, ta, td = (t.detach().numpy() for t in t_out[:3])
    ji, ja, jd = (np.asarray(t) for t in j_out[:3])
    np.testing.assert_allclose(ti, ji, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-5)
    covered = ja > 0.05
    assert covered.any()
    np.testing.assert_allclose(td[covered], jd[covered], rtol=1e-3, atol=1e-4)
    for f in fields:
        assert_grads_close(getattr(tg, f).grad.numpy(),
                           np.asarray(getattr(j_grads, f)), f)


def test_axis_binned_matches_dense_without_drops(monkeypatch):
    """With nothing dropped, the separable binned sum (K7a's twin) is the
    dense band one (K1's): accum_binned 'on' against 'off' on the port
    alone, values and gradients."""
    _, tg = scene(700, 15)
    c = tcam.orbit_cameras(2, 256, 48, device="cpu")[1]
    cfg = TConfig(width=256, height=48, mode="accum", impl="tiled")
    calls = []
    counted(monkeypatch, tbinned, "binned_sep_fwd", calls)
    outs = {}
    for mode in ("on", "off"):
        tg.means.grad = None
        tg.means.requires_grad_(True)
        img, alpha, _, stats = tdispatch.render_accum(
            tg, c.view, c.proj, cfg.replace(accum_binned=mode),
            return_stats=True)
        (img.sum() + alpha.square().sum()).backward()
        outs[mode] = (img.detach(), alpha.detach(), tg.means.grad.clone())
        assert all(int(v) == 0 for v in stats.values())
    assert calls == ["binned_sep_fwd"]
    for a, b in zip(outs["on"][:2], outs["off"][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    assert_grads_close(outs["on"][2].numpy(), outs["off"][2].numpy(), "means")


def axis_binned_config(module, **kw):
    """The flagship recipe's axis fit at 32x32 under --accum_binned on
    (capacity 3000: auto -> accum), densify/prune at iteration 5."""
    base = dict(targets_dir=str(SCENE), camera_npz=str(SCENE / "cameras.npz"),
                iters=6, width=32, height=32, use_sh=True,
                accum_binned="on", densify_interval=5, prune_interval=5,
                log_every=5)
    return module.FitConfig(**{**base, **kw})


def test_axis_binned_fit_follows_jax(tmp_path, capsys, monkeypatch):
    """6 iterations from the JAX trainer's own initial arrays and densify
    draws (trainer.py:93-94, :303): every step through K7a/K7b's twins, the
    preview through K1's (JAX's preview config sets no accum_binned)."""
    j_cfg = axis_binned_config(jconfig, impl="pallas")
    targets, masks, depths, j_cams = jtrainer.load_dataset(j_cfg)
    j_res = jtrainer.fit(j_cfg, targets, j_cams, masks=masks, depths=depths)
    capsys.readouterr()

    capacity = j_cfg.max_gaussians
    key, k_init = jax.random.split(jax.random.PRNGKey(j_cfg.seed))
    raw0 = jmodel.init_params(k_init, j_cfg.num_gaussians, capacity,
                              use_sh=True)
    key, k_d = jax.random.split(key)
    noise = {5: torch.from_numpy(np.array(jax.random.normal(
        k_d, (capacity, 3), jnp.float32)))}

    calls = []
    for name in ("binned_sep_fwd", "binned_sep_bwd", "binned_fwd",
                 "binned_bwd"):
        counted(monkeypatch, tbinned, name, calls)
    for name in ("splat_sep_fwd", "splat_sep_bwd"):
        counted(monkeypatch, TS, name, calls)
    t_cfg = axis_binned_config(tconfig, impl="tiled")
    assert tconfig.resolve_render_mode(t_cfg, capacity) == "accum"
    t_targets, t_masks, t_depths, t_cams = ttrainer.load_dataset(
        t_cfg, device="cpu")
    t_res = ttrainer.fit(t_cfg, t_targets, t_cams, masks=t_masks,
                         depths=t_depths, out_dir=tmp_path, device="cpu",
                         raw0=tmodel.raw_from_numpy(arrays_of(raw0), "cpu"),
                         densify_noise=noise.__getitem__)
    steps = (["binned_sep_fwd"] * 6 + ["binned_sep_bwd"] * 6) * 6
    assert calls == steps                     # 6 views, 6 steps
    ttrainer.write_artifacts(tmp_path, t_res, t_cfg)
    assert calls == steps + ["splat_sep_fwd"]  # the preview
    capsys.readouterr()

    assert len(t_res.loss_log) == len(j_res.loss_log) == 6
    np.testing.assert_allclose(t_res.loss_log, j_res.loss_log, rtol=1e-3)
    n_metric = [float(line.split('"n_alive": ')[1].split(",")[0]) for line in
                (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert n_metric[0] == 800 and n_metric[5] > 800
    assert int(t_res.raw.num_alive()) == int(j_res.raw.num_alive())
    for name in ("gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                 "preview_view0.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_fit_cli_trains_axis_binned(tmp_path, capsys, monkeypatch):
    """`cli.fit --accum_binned on` with the default axis footprint trains
    (K7a/K7b's twins here) and writes the four artifacts."""
    calls = []
    counted(monkeypatch, tbinned, "binned_sep_bwd", calls)
    out = tmp_path / "fit"
    tfit_cli.main(["--targets_dir", str(SCENE), "--camera_npz",
                   str(SCENE / "cameras.npz"), "--iters", "2", "--width",
                   "32", "--height", "32", "--use_sh", "--accum_binned",
                   "on", "--out_dir", str(out), "--device", "cpu"])
    capsys.readouterr()
    assert calls == ["binned_sep_bwd"] * 12
    losses = [float(x) for x in (out / "loss.txt").read_text().splitlines()]
    assert len(losses) == 2 and np.isfinite(losses).all()
    for name in ("gaussians_fitted.npz", "metrics.jsonl",
                 "preview_view0.png"):
        assert (out / name).stat().st_size > 0

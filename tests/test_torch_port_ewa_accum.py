"""Port parity, EWA accumulation training (slice 4): the dense band
backward K6 (`kernels.splat_v2.v2_bwd_plain`, the CUDA kernel's plain
twin), the accumulation binner, the tile-binned K8a/K8b twins
(`kernels.binned`), `ops.binned.splat_accumulate_binned`, EWA
render(mode="accum") with its binned knobs, and two short EWA accumulation
fits, against `tpu_gaussians` (its Pallas kernels in interpret mode on the
CPU, as the JAX suite runs them) on identical numpy inputs.

Tolerances:
- K6's and K8b's raw moment rows: rtol 2e-4, and atol 2e-5 times the
  largest magnitude of the output column (at least 2e-5), as K2's in
  tests/test_torch_port_splat.py: the moments sum signed terms that cancel;
- K8a's sums: rtol 1e-5 / atol 1e-5 (tests/test_pallas_parity.py:106-113);
- the dense splat_accumulate(axis=False) values rtol/atol 1e-5 and the
  gradients of sum(acc * g) rtol 2e-4 and atol 2e-5 times the largest
  magnitude of that gradient (at least 2e-5), as the axis footprint's;
- the binned renders (tests/test_binned_accum.py:32-37, 93-96): image and
  alpha rtol 1e-4 / atol 1e-5, depth rtol 1e-3 / atol 1e-4 on covered
  pixels, gradients rtol 2e-3 and atol 2e-4 times the largest magnitude;
  the binner's lists, counts and stats exact;
- the fits: loss curve rtol 1e-3, N exact (tests/test_torch_port_fit.py).
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
from tpu_gaussians.ops import common as jcommon
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians.ops.pallas import binned as PB
from tpu_gaussians.ops.pallas import sorted as PS
from tpu_gaussians.ops.pallas import splat as JS
from tpu_gaussians.utils import config as jconfig
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.fit import trainer as ttrainer
from tpu_gaussians_torch.kernels import binned as kbinned
from tpu_gaussians_torch.kernels import splat_v2
from tpu_gaussians_torch.models import gaussian_model as tmodel
from tpu_gaussians_torch.ops import binned as tbinned
from tpu_gaussians_torch.ops import binning as tbinning
from tpu_gaussians_torch.ops import common as tcommon
from tpu_gaussians_torch.ops import dispatch as tdispatch
from tpu_gaussians_torch.ops import splat as TS
from tpu_gaussians_torch.utils import config as tconfig

from .test_torch_port_cuda import (CAP, TILES_X, assert_moments_close,
                                   synthetic_lists)
from .test_torch_port_fit import arrays_of
from .test_torch_port_render import scene
from .test_torch_port_sorted_bwd import (  # noqa: F401 (autouse fixture)
    assert_grads_close, one_torch_thread)
from .test_torch_port_sorted_fit import (V2_CASES, ewa_config, ewa_splats,
                                         jcommon_inputs)

NAMES = ("px", "py", "conic_a", "conic_b", "conic_c", "op_eff", "feats")


def torch_inputs(cols):
    n = cols[0].shape[0]
    return tcommon.SplatInputs(*map(torch.from_numpy, cols[:5]),
                               sigma_x=torch.zeros(n), sigma_y=torch.zeros(n),
                               op_eff=torch.from_numpy(cols[5]),
                               feats=torch.from_numpy(cols[6]))


@pytest.mark.parametrize("n,height,width", V2_CASES)
def test_v2_bwd_twin_matches_tpu_kernel(n, height, width):
    s = torch_inputs(ewa_splats(n, height, width, seed=n))
    lo, cnt, gdata, nb, hw_pad = TS._v2_prep(TS.y_sorted(s), height, width)
    g8 = np.random.default_rng(n).normal(size=(8, hw_pad)).astype(np.float32)
    g8[5:] = 0.0
    ref = np.asarray(JS._bwd_call_v2(
        jnp.asarray(lo.numpy()[None]), jnp.asarray(cnt.numpy()[None]),
        jnp.asarray(gdata.numpy().T), jnp.asarray(g8), hw_pad, width, nb)).T
    before = dict(splat_v2.launches)
    out = splat_v2.splat_v2_bwd(lo, cnt, gdata, torch.from_numpy(g8), hw_pad,
                                width, nb)
    assert splat_v2.launches == before        # no kernel launched on CPU
    assert_moments_close(out.numpy(), ref)
    assert not out[:, 5].any() and not out[:, 14:].any()


@pytest.mark.parametrize("n,height,width", [(300, 40, 64), (2500, 48, 80)])
def test_ewa_splat_accumulate_values_and_grads_match_jax(n, height, width):
    """Below SORT_MM_MAX (no y-sort) and above (y-sorted: the gradient
    comes back through the sort's gather)."""
    cols = ewa_splats(n, height, width, seed=n + 1)
    g_out = np.random.default_rng(2).normal(
        size=(height * width, 5)).astype(np.float32)
    base_j = jcommon_inputs(cols)._asdict()

    def f_jax(*leaves):
        s = jcommon.SplatInputs(**{**base_j, **dict(zip(NAMES, leaves))})
        acc = JS.splat_accumulate(s, height, width, axis=False)
        return jnp.sum(acc * g_out), acc

    (_, j_acc), j_grads = jax.jit(jax.value_and_grad(
        f_jax, argnums=tuple(range(len(NAMES))), has_aux=True))(
            *(base_j[k] for k in NAMES))

    s = torch_inputs(cols)
    s = s._replace(**{k: getattr(s, k).clone().requires_grad_(True)
                      for k in NAMES})
    before = dict(splat_v2.launches)
    t_acc = TS.splat_accumulate(s, height, width, axis=False)
    (t_acc * torch.from_numpy(g_out)).sum().backward()
    assert splat_v2.launches == before
    np.testing.assert_allclose(t_acc.detach().numpy(), np.asarray(j_acc),
                               rtol=1e-5, atol=1e-5)
    for k, jg in zip(NAMES, j_grads):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1.0)
        np.testing.assert_allclose(getattr(s, k).grad.numpy(), jg, rtol=2e-4,
                                   atol=2e-5 * scale, err_msg=f"grad of {k}")


@pytest.mark.parametrize("n,width,height,cap,cutoff", [
    (600, 200, 72, 1024, "w_cull"),          # no overflow, ragged tiles
    (3000, 128, 64, 512, "w_cull"),          # every tile overflows cap 512
    (3000, 256, 48, 512, "alpha"),           # the alpha extents
])
def test_accum_binner_matches_jax(n, width, height, cap, cutoff):
    """bin_pairs_2d(zsort=False) against _bin_pairs_2d(zsort=False) with
    the accumulation's pair budget: JAX's slots index its priority-ordered
    table (pack_gdataT_prio), the port's the gaussians themselves, so
    slot v of JAX is gaussian order[v] (n, the dead row, stays n)."""
    jg, tg = scene(n, 11, quats=True)
    c = tcam.orbit_cameras(3, width, height, device="cpu")[1]
    s = tcommon.prepare_splats(tg, c.view, c.proj, width, height,
                               footprint="ewa")
    cut = tbinned.W_CULL if cutoff == "w_cull" else tbinned.ALPHA_CUTOFF
    tiles_x, tiles_y = -(-width // 128), -(-height // 16)
    k = tbinning.k_pairs(n, budget=tbinning.ACCUM_PAIR_BUDGET,
                         kmin=tbinning.ACCUM_K_MIN)
    assert k == PS._k_pairs(n, budget=PB.ACCUM_PAIR_BUDGET,
                            kmin=PB.ACCUM_K_MIN)
    cols = [t.detach() for t in (s.px, s.py, s.sigma_x, s.sigma_y, s.op_eff)]
    slots, cnt, stats = tbinning.bin_pairs_2d(
        *cols, None, tiles_x, tiles_y, cap, width, height, cutoff=cut,
        zsort=False, k=k)
    order, j_slots, j_cnt, j_stats = jax.jit(
        lambda *c: PS._bin_pairs_2d(*c, None, tiles_x, tiles_y, cap, width,
                                    height, cutoff=cut, zsort=False, k=k))(
        *(jnp.asarray(t.numpy()) for t in cols))
    order, j_slots = np.asarray(order), np.asarray(j_slots)
    mapped = np.where(j_slots < n, order[np.minimum(j_slots, n - 1)], n)
    np.testing.assert_array_equal(slots.numpy(), mapped)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt)[0])
    assert {k: int(v) for k, v in stats.items()} == {
        k: int(v) for k, v in j_stats.items()}
    if cap == 512:
        assert int(stats["dropped_pairs"]) > 0
    # each list runs strongest first, so overflow drops the weakest
    op = torch.cat([s.op_eff.detach(), torch.zeros(1)])[slots.reshape(
        -1, cap)]
    assert bool((op[:, 1:] <= op[:, :-1]).all())


def test_binned_twins_match_tpu_kernels():
    """K8a/K8b twins against _binned_fwd_call / _binned_bwd_call(sep=False)
    on transposed copies of the same lists: a full tile, a partial second
    chunk, an empty tile and a short one."""
    gdense, cnt = synthetic_lists(False, cnt=(1024, 600, 0, 300))
    gd_t, cnt_t = jnp.asarray(gdense.numpy().T), jnp.asarray(cnt.numpy()[None])
    ref = np.asarray(PB._binned_fwd_call(gd_t, cnt_t, TILES_X, 4,
                                         CAP // PB.NBS, sep=False))
    before = dict(kbinned.launches)
    acc = kbinned.binned_fwd(gdense, cnt, TILES_X)
    np.testing.assert_allclose(acc.numpy(), ref, rtol=1e-5, atol=1e-5)
    g8 = np.random.default_rng(3).normal(size=ref.shape).astype(np.float32)
    ref_b = np.asarray(PB._binned_bwd_call(gd_t, cnt_t, jnp.asarray(g8),
                                           TILES_X, 4, CAP // PB.NBS,
                                           sep=False)).T
    out = kbinned.binned_bwd(gdense, cnt, torch.from_numpy(g8), TILES_X)
    assert kbinned.launches == before         # no kernel launched on CPU
    assert_moments_close(out.numpy(), ref_b)
    rows = out.reshape(4, CAP, 16)
    assert not rows[2].any() and not rows[3, 512:].any()
    assert rows[1, 599].any() and not rows[1, 600:].any()   # dead rows
    assert not acc.reshape(8, 4, 2048)[:, 2].any()


def test_binned_wrapper_contract():
    gdense, cnt = synthetic_lists(False)
    g8 = torch.zeros((8, 4 * 2048))
    meta = [t.to("meta") for t in (gdense, cnt)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        kbinned.binned_fwd(*meta, TILES_X)
    with pytest.raises(ValueError, match="g8"):
        kbinned.binned_bwd(gdense, cnt, g8[:, :-1], TILES_X)
    with pytest.raises(ValueError):
        kbinned.binned_fwd(gdense[:-16], cnt, TILES_X)
    with pytest.raises(ValueError, match="int32"):
        kbinned.binned_fwd(gdense, cnt.long(), TILES_X)


def binned_loss(render_fn, lib, wi, wa):
    def f(g, view, proj):
        img, alpha, depth, stats = render_fn(g, view, proj)
        return lib.sum(img * wi) + lib.sum(alpha * wa), (img, alpha, depth,
                                                          stats)
    return f


@pytest.mark.parametrize("n,width,height,knobs", [
    (500, 160, 40, dict(accum_binned="on")),
    (10_240, 128, 32, dict()),                               # auto -> binned
    (2000, 128, 48, dict(accum_binned="on", accum_cull="alpha",
                         accum_tile_capacity=512)),
], ids=["on", "auto_10240", "alpha_cap512"])
def test_binned_render_accum_matches_jax(n, width, height, knobs):
    jg, tg = scene(n, 12, sh=True, quats=True)
    rng = np.random.default_rng(n)
    wi = rng.normal(size=(height, width, 3)).astype(np.float32)
    wa = rng.normal(size=(height, width)).astype(np.float32)
    kw = dict(width=width, height=height, mode="accum", footprint="ewa",
              background=(0.1, 0.0, 0.2), **knobs)
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
    fields = ("means", "scales", "opacities", "sh", "quats")
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


def test_binned_matches_dense_without_drops():
    """With nothing dropped, the binned sum is the dense one (W_CULL
    extents): accum_binned 'on' against 'off' on the port alone."""
    _, tg = scene(700, 13, quats=True)
    c = tcam.orbit_cameras(2, 256, 48, device="cpu")
    cfg = TConfig(width=256, height=48, mode="accum", footprint="ewa",
                  impl="tiled", return_aux=True)
    with torch.no_grad():
        on = tdispatch.render(tg, c, cfg.replace(accum_binned="on"))
        off = tdispatch.render(tg, c, cfg.replace(accum_binned="off"))
        *_, stats = tdispatch.render_accum(
            tg, c.view[0], c.proj[0], cfg.replace(accum_binned="on"),
            return_stats=True)
    assert all(int(v) == 0 for v in stats.values())
    for a, b in zip(on[:2], off[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def counted(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(name)
        return fn(*args)

    monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("size,capacity,render_mode,kernels", [
    (48, 3000, "auto", ("splat_v2_fwd", "splat_v2_bwd")),
    (32, 10_240, "accum", ("binned_fwd", "binned_bwd")),
], ids=["dense", "binned"])
def test_ewa_accum_fit_follows_jax(tmp_path, capsys, monkeypatch, size,
                                   capacity, render_mode, kernels):
    """6 iterations from the JAX trainer's own initial arrays and densify
    draws (trainer.py:93-94, :303), densify/prune at iteration 5: the EWA
    accumulation training of both routes (their kernels' twins here), and
    the preview through JAX's accum_binned="auto" (K5, or K8a at capacity
    >= BINNED_MIN_N)."""
    kw = dict(iters=6, width=size, height=size, max_gaussians=capacity,
              render_mode=render_mode)
    j_cfg = ewa_config(jconfig, impl="pallas", **kw)
    targets, masks, depths, j_cams = jtrainer.load_dataset(j_cfg)
    j_res = jtrainer.fit(j_cfg, targets, j_cams, masks=masks, depths=depths)
    capsys.readouterr()

    key, k_init = jax.random.split(jax.random.PRNGKey(j_cfg.seed))
    raw0 = jmodel.init_params(k_init, j_cfg.num_gaussians, capacity,
                              use_sh=True, use_quats=True)
    key, k_d = jax.random.split(key)
    noise = {5: torch.from_numpy(np.array(jax.random.normal(
        k_d, (capacity, 3), jnp.float32)))}

    calls = []
    for name in ("splat_v2_fwd", "splat_v2_bwd"):
        counted(monkeypatch, TS, name, calls)
    for name in ("binned_fwd", "binned_bwd"):
        counted(monkeypatch, tbinned, name, calls)
    t_cfg = ewa_config(tconfig, impl="tiled", **kw)
    assert tconfig.resolve_render_mode(t_cfg, capacity) == "accum"
    t_targets, t_masks, t_depths, t_cams = ttrainer.load_dataset(
        t_cfg, device="cpu")
    t_res = ttrainer.fit(t_cfg, t_targets, t_cams, masks=t_masks,
                         depths=t_depths, out_dir=tmp_path, device="cpu",
                         raw0=tmodel.raw_from_numpy(arrays_of(raw0), "cpu"),
                         densify_noise=noise.__getitem__)
    fwd, bwd = kernels
    assert calls == ([fwd] * 6 + [bwd] * 6) * 6   # 6 views, 6 steps
    ttrainer.write_artifacts(tmp_path, t_res, t_cfg)
    assert calls[72:] == [fwd]                    # the preview
    capsys.readouterr()

    assert len(t_res.loss_log) == len(j_res.loss_log) == 6
    np.testing.assert_allclose(t_res.loss_log, j_res.loss_log, rtol=1e-3)
    n_metric = [float(line.split('"n_alive": ')[1].split(",")[0]) for line in
                (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert n_metric[0] == 800 and n_metric[5] == 920
    assert int(t_res.raw.num_alive()) == int(j_res.raw.num_alive())
    for name in ("gaussians_fitted.npz", "loss.txt", "metrics.jsonl",
                 "preview_view0.png"):
        assert (tmp_path / name).stat().st_size > 0

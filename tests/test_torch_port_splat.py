"""Port parity, the separable band accumulation (slice 2's kernel module):
`tpu_gaussians_torch.ops.splat` and `kernels.splat_sep` against
`tpu_gaussians.ops.pallas.splat` (its kernels in interpret mode on the
CPU, as the JAX suite runs them), on identical numpy inputs; and
render(mode="accum") of both packages.

Tolerances:
- staging (cull mask, block ranges, packed rows, y-sort order): exact;
- K1's twin and the accumulated values: rtol 1e-5 / atol 1e-5, the JAX
  suite's (tests/test_pallas_parity.py:106-113);
- K2's twin and the gradients of sum(acc * g) for a fixed N(0,1) g:
  rtol 2e-4, and atol 2e-5 times the largest magnitude of that output
  (at least 2e-5). The JAX suite's 2e-4 / 2e-5 (test_pallas_parity.py:
  116-145) holds at its 23 gaussians on 40x24; here the moments sum up to
  ~1e5 signed terms that cancel to values near zero, and f32 rounding is
  relative to the terms, not to the sum;
- renders: image and alpha rtol 1e-5 / atol 1e-5, depth rtol 1e-4 /
  atol 1e-4 (test_pallas_parity.py:67-80).
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.ops import common as jcommon
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians.ops.pallas import splat as JS
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.kernels import build, splat_sep
from tpu_gaussians_torch.ops import common as tcommon
from tpu_gaussians_torch.ops import dispatch as tdispatch
from tpu_gaussians_torch.ops import splat as TS

from .test_torch_port_cuda import (assert_moments_close, splat_inputs,
                                   synthetic_splats)
from .test_torch_port_render import assert_frames_match, scene

# (n, height, width): one band, no sort; 4 bands of R = 64, sorted, n not
# a multiple of nb; 3 bands of R = 32 (past SEP_SMALL_MAX_N).
CASES = [(300, 64, 64), (5000, 200, 136), (20000, 96, 128)]
IDS = ["300_64x64", "5000_200x136", "20000_96x128"]


def jax_order(cols):
    """The columns in the y-order of JAX's splat_accumulate (splat.py:1214)."""
    if cols[0].shape[0] > JS.SORT_MM_MAX:
        order = np.argsort(cols[1], kind="stable")
        cols = tuple(np.ascontiguousarray(c[order]) for c in cols)
    return cols


def staged_both(cols, height, width):
    """JAX's staging of the columns in its y-order, and the port's
    ops/splat.stage of the columns as given (it sorts them itself)."""
    j = JS._sep_prep(*map(jnp.asarray, jax_order(cols)), height, width)
    _, t = TS.stage(splat_inputs(cols), height, width)
    return j, t


@pytest.mark.parametrize("n,height,width", CASES, ids=IDS)
def test_staging_matches_jax_exactly(n, height, width):
    cols = synthetic_splats(n, height, width, seed=n)
    iota = jnp.arange(n, dtype=jnp.int32)
    _, j_order = jax.lax.sort((jnp.asarray(cols[1]), iota), num_keys=1)
    t_order = torch.sort(torch.from_numpy(cols[1]), stable=True).indices
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))

    j, t = staged_both(cols, height, width)
    cols = jax_order(cols)
    assert t[3:] == j[3:]                # nb, wp, hp, n_bands, rows
    nb, wp, _, n_bands, rows = t[3:]
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0])[0])
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1])[0])
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]).T)
    # the mask itself, on the padded inputs
    n_pad = t[2].shape[0]
    jp = JS._pad_inputs(*map(jnp.asarray, cols), n_pad)
    tp = TS._pad_inputs(*map(torch.from_numpy, cols), n_pad)
    j_sy = JS._sigma_y_from_conic(jp[2][:, 0], jp[3][:, 0], jp[4][:, 0])
    t_sy = TS._sigma_y_from_conic(tp[2], tp[3], tp[4])
    # XLA may contract a*c - b*b into one fma: 1 ulp apart at most
    np.testing.assert_allclose(t_sy.numpy(), np.asarray(j_sy), rtol=2.5e-7,
                               atol=0)
    j_mask = JS._band_block_mask(jp[1][:, 0], j_sy, jp[5][:, 0], n_bands,
                                 rows * wp, nb, wp)
    t_mask = TS._band_block_mask(tp[1], torch.from_numpy(np.array(j_sy)),
                                 tp[5], n_bands, rows * wp, nb, wp)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    lo, cnt = TS._block_ranges(t_mask)
    assert lo.tolist() == t[0].tolist() and cnt.tolist() == t[1].tolist()


@pytest.mark.parametrize("n,height,width", CASES, ids=IDS)
def test_plain_twins_match_tpu_kernels(n, height, width):
    j, t = staged_both(synthetic_splats(n, height, width, seed=n), height,
                       width)
    lo, cnt, gdata, nb, wp, _, n_bands, rows = t
    acc = splat_sep.sep_fwd_plain(lo, cnt, gdata, rows, wp, nb)
    ref = np.asarray(JS._fwd_call_sep(j[0], j[1], j[2], n_bands, wp, nb,
                                      rows)).reshape(n_bands, 8, rows, wp)
    assert not ref[:, 5:].any()          # only r, g, b, 1, z are non-zero
    np.testing.assert_allclose(acc.numpy(), ref[:, :5], rtol=1e-5,
                               atol=1e-5)

    rng = np.random.default_rng(1)
    gband = rng.normal(size=(n_bands, 5, rows, wp)).astype(np.float32)
    g8 = np.zeros((n_bands, 8, rows, wp), np.float32)
    g8[:, :5] = gband
    ref_b = np.asarray(JS._bwd_call_sep(
        j[0], j[1], j[2], jnp.asarray(g8.reshape(-1, wp)), n_bands, wp, nb,
        rows)).T
    out = splat_sep.sep_bwd_plain(lo, cnt, gdata, torch.from_numpy(gband),
                                  rows, wp, nb)
    assert_moments_close(out.numpy(), ref_b)


@pytest.mark.parametrize("n,height,width", CASES, ids=IDS)
def test_splat_accumulate_values_and_grads_match_jax(n, height, width):
    cols = synthetic_splats(n, height, width, seed=n)
    rng = np.random.default_rng(2)
    g_out = rng.normal(size=(height * width, 5)).astype(np.float32)
    names = ["px", "py", "conic_a", "conic_c", "op_eff", "feats"]

    def inputs(lib, arrs):
        px, py, ca, cb, cc, op, feats = arrs
        return dict(px=px, py=py, conic_a=ca, conic_b=cb, conic_c=cc,
                    sigma_x=1.0 / lib.sqrt(ca), sigma_y=1.0 / lib.sqrt(cc),
                    op_eff=op, feats=feats)

    base_j = inputs(jnp, [jnp.asarray(c) for c in cols])

    def f_jax(*leaves):
        s = jcommon.SplatInputs(**{**base_j, **dict(zip(names, leaves))})
        acc = JS.splat_accumulate(s, height, width, axis=True)
        return jnp.sum(acc * g_out), acc

    (_, j_acc), j_grads = jax.value_and_grad(
        f_jax, argnums=tuple(range(6)), has_aux=True)(
            *(base_j[k] for k in names))

    t_in = inputs(torch, [torch.from_numpy(c) for c in cols])
    for k in names:
        t_in[k].requires_grad_(True)
    t_acc = TS.splat_accumulate(tcommon.SplatInputs(**t_in), height, width,
                                axis=True)
    (t_acc * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_allclose(t_acc.detach().numpy(), np.asarray(j_acc),
                               rtol=1e-5, atol=1e-5)
    for k, jg in zip(names, j_grads):
        jg = np.asarray(jg)
        tg = t_in[k].grad.numpy()
        scale = max(float(np.abs(jg).max()), 1.0)
        np.testing.assert_allclose(tg, jg, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg=f"grad of {k}")


def test_general_conic_accumulation_is_refused():
    """splat_accumulate(axis=False) is K5's forward, equal to JAX's; its
    gradient in px, once refused, now comes through K6 (its twin here)
    and equals JAX's (tests/test_torch_port_ewa_accum.py holds every
    field)."""
    cols = list(synthetic_splats(50, 16, 16))
    cols[3] = (0.5 * np.sqrt(cols[2] * cols[4])).astype(np.float32)
    s = tcommon.SplatInputs(*map(torch.from_numpy, cols[:5]),
                            sigma_x=torch.ones(50), sigma_y=torch.ones(50),
                            op_eff=torch.from_numpy(cols[5]),
                            feats=torch.from_numpy(cols[6]))
    with torch.no_grad():
        acc = TS.splat_accumulate(s, 16, 16, axis=False)
    px, py, ca, cb, cc, op, feats = map(jnp.asarray, cols)

    def j_acc(px):
        return JS.splat_accumulate(jcommon.SplatInputs(
            px=px, py=py, conic_a=ca, conic_b=cb, conic_c=cc,
            sigma_x=jnp.ones(50), sigma_y=jnp.ones(50), op_eff=op,
            feats=feats), 16, 16, axis=False)

    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc(px)), rtol=1e-5,
                               atol=1e-5)
    s = s._replace(px=s.px.clone().requires_grad_(True))
    TS.splat_accumulate(s, 16, 16, axis=False)[:, :3].sum().backward()
    want = np.asarray(jax.grad(lambda x: jnp.sum(j_acc(x)[:, :3]))(px))
    np.testing.assert_allclose(s.px.grad.numpy(), want, rtol=2e-4,
                               atol=2e-5 * max(1.0, float(np.abs(want).max())))


def test_wrappers_take_plain_twins_on_cpu_only():
    lo, cnt, gdata, nb, wp, _, n_bands, rows = TS._sep_prep(
        *map(torch.from_numpy, synthetic_splats(700, 40, 64)), 40, 64)
    before = dict(splat_sep.launches)
    acc = splat_sep.splat_sep_fwd(lo, cnt, gdata, rows, wp, nb)
    assert torch.equal(acc, splat_sep.sep_fwd_plain(lo, cnt, gdata, rows,
                                                    wp, nb))
    gband = torch.ones_like(acc)
    out = splat_sep.splat_sep_bwd(lo, cnt, gdata, gband, rows, wp, nb)
    assert torch.equal(out, splat_sep.sep_bwd_plain(lo, cnt, gdata, gband,
                                                    rows, wp, nb))
    assert splat_sep.launches == before      # no kernel launched on CPU
    meta = [t.to("meta") for t in (lo, cnt, gdata)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        splat_sep.splat_sep_fwd(*meta, rows, wp, nb)
    with pytest.raises(ValueError):
        splat_sep.splat_sep_fwd(lo, cnt, gdata[:-1], rows, wp, nb)
    with pytest.raises(ValueError):
        splat_sep.splat_sep_fwd(lo.long(), cnt, gdata, rows, wp, nb)
    with pytest.raises(ValueError, match="band height"):
        splat_sep.splat_sep_fwd(lo, cnt, gdata, 16, wp, nb)
    with pytest.raises(ValueError):
        splat_sep.splat_sep_bwd(lo, cnt, gdata, gband[:, :4].contiguous(),
                                rows, wp, nb)


def test_kernel_builds_need_nvcc():
    if build.shutil.which("nvcc") or build.os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: this checks the no-toolchain refusal")
    for name in ("splat_sep_fwd", "splat_sep_bwd", "sorted_bwd",
                 "splat_v2_fwd", "splat_v2_bwd", "binned_fwd", "binned_bwd"):
        assert name in build.KERNELS
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build_all((name,))


def test_launch_passes_pointers_scalars_and_stream(monkeypatch):
    """build.launch, which every wrapper launches through, passes tensors
    as device pointers, Python floats as C floats and other scalars as C
    ints, then the current stream; a non-zero CUDA error raises."""
    calls, errs = [], [0]

    def fn(*args):
        calls.append(args)
        return errs[0]

    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        **{f"{name}_launch": fn}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=4096))
    a, b = torch.zeros(4), torch.zeros(2, dtype=torch.int32)
    build.launch("k", (a, b), 3, np.int64(5), 0.25, True)
    (args,) = calls
    assert [type(x) for x in args] == (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    assert [x.value for x in args] == [a.data_ptr(), b.data_ptr(), 3, 5,
                                       0.25, 1, 4096]
    assert fn.restype is ctypes.c_int
    errs[0] = 700
    with pytest.raises(RuntimeError, match="k_launch failed with CUDA "
                                           "error 700"):
        build.launch("k", (a,))


@pytest.mark.parametrize("impl,sh", [("tiled", False), ("tiled", True),
                                     ("torch", True)])
def test_accum_render_matches_jax(impl, sh):
    jg, tg = scene(400, 5, sh=sh)
    w, h = 96, 72
    kw = dict(width=w, height=h, mode="accum", return_aux=True,
              background=(0.1, 0.0, 0.2), chunk_size=64)
    j_impl = "pallas" if impl == "tiled" else "jnp"
    j_out = jdispatch.render(jg, jcam.orbit_cameras(4, w, h)[1],
                             JConfig(impl=j_impl, **kw))
    t_out = tdispatch.render(tg, tcam.orbit_cameras(4, w, h, device="cpu")[1],
                             TConfig(impl=impl, **kw))
    ti, ta, td = (x.detach().numpy() for x in t_out)
    ji, ja, jd = (np.asarray(x) for x in j_out)
    np.testing.assert_allclose(ti, ji, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)


def test_accum_render_batched_and_stats_match_jax():
    jg, tg = scene(300, 6)
    kw = dict(width=64, height=32, mode="accum", return_aux=True)
    j_out = jdispatch.render(jg, jcam.orbit_cameras(2, 64, 32),
                             JConfig(impl="pallas", **kw))
    t_out = tdispatch.render(tg, tcam.orbit_cameras(2, 64, 32, device="cpu"),
                             TConfig(impl="tiled", **kw))
    assert t_out[0].shape == (2, 32, 64, 3)
    assert_frames_match(tuple(x.detach() for x in t_out), j_out)
    c = tcam.orbit_cameras(2, 64, 32, device="cpu")[0]
    *_, stats = tdispatch.render_accum(tg, c.view, c.proj, TConfig(**kw),
                                       return_stats=True)
    assert all(int(v) == 0 for v in stats.values())


def test_tiled_accum_refuses_unported_kernels():
    """EWA accumulation renders through K5 below BINNED_MIN_N and through
    the binned K8a under accum_binned='on'; the axis footprint's binned
    kernels (K7, accum_binned='on') render as well: nothing is refused."""
    _, tg = scene(50, 7)
    c = tcam.orbit_cameras(1, 64, 32, device="cpu")
    cfg = TConfig(width=64, height=32, mode="accum", impl="tiled")
    # the plain renderer takes either footprint
    ref = tdispatch.render(tg, c, cfg.replace(footprint="ewa", impl="torch"))
    # dense K5 at the plain renderer's 1e-5; binned K8a at
    # tests/test_binned_accum.py's 1e-4
    for binned, rtol in (("auto", 1e-5), ("on", 1e-4)):
        with torch.no_grad():
            img = tdispatch.render(tg, c, cfg.replace(footprint="ewa",
                                                      accum_binned=binned))
        assert img.shape == (1, 32, 64, 3) and bool(torch.isfinite(img).all())
        np.testing.assert_allclose(img.numpy(), ref.detach().numpy(),
                                   rtol=rtol, atol=1e-5)
    ref = tdispatch.render(tg, c, cfg.replace(impl="torch"))
    with torch.no_grad():
        img = tdispatch.render(tg, c, cfg.replace(accum_binned="on"))
    np.testing.assert_allclose(img.numpy(), ref.detach().numpy(), rtol=1e-4,
                               atol=1e-5)
    assert tdispatch.uses_binned_accum(cfg.replace(footprint="ewa"),
                                       tdispatch.BINNED_MIN_N)
    assert not tdispatch.uses_binned_accum(
        cfg.replace(footprint="ewa", accum_binned="off"),
        tdispatch.BINNED_MIN_N)
    assert not tdispatch.uses_binned_accum(cfg, 10 ** 7)

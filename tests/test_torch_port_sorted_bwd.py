"""Port parity, the sorted backward (slice 3's kernel module K4):
`kernels.sorted_bwd.sorted_bwd_plain` (the CUDA kernel's plain twin),
`ops.sorted.moment_postpass` and the gradients of render(mode="sorted",
impl="tiled") against `tpu_gaussians` (its Pallas kernels in interpret mode
on the CPU, as the JAX suite runs them), on identical numpy inputs.

Tolerances are the JAX suite's for its fused sorted backward
(tests/test_sorted_vjp.py): rtol 2e-3 and atol 2e-4 times the largest
magnitude of the reference (per output column for the raw moment rows,
per parameter for the gradients). `ctg - P_i` in the backward is a
difference of near-equal sums divided by 1 - a >= 1e-4, so it rounds far
above the forward's 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians.ops.pallas import sorted as PS
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.kernels import sorted_bwd, sorted_fwd
from tpu_gaussians_torch.ops import dispatch as tdispatch
from tpu_gaussians_torch.ops import sorted as tsorted

from .test_torch_port_cuda import CAP, TILES_X, synthetic_lists
from .test_torch_port_render import scene

FIELDS = ("means", "scales", "colors", "opacities")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain twins run thousands of small elementwise ops; under the
    suite's parallel workers torch's intra-op threads oversubscribe the
    cores and spend more CPU than they save. Restored after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_grads_close(got, want, name):
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * scale,
                               err_msg=f"grad mismatch for {name}")


@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("exit_t", [1e-6, 1e-3])
def test_plain_twin_matches_tpu_kernel(footprint, exit_t):
    """Tile 0 is near-opaque and exits after its first chunk, tile 1 runs
    both chunks, tile 2 holds 900 slots (not a multiple of 512), tile 3
    none."""
    axis = footprint == "axis"
    gdense, cnt = synthetic_lists(axis, cnt=(1024, 1024, 900, 0))
    gd_t, cnt_t = jnp.asarray(gdense.numpy().T), jnp.asarray(cnt.numpy()[None])
    acc = PS._sorted_fwd_call(gd_t, cnt_t, TILES_X, 4, CAP // PS.NBS,
                              axis=axis, exit_t=exit_t)
    g8 = np.random.default_rng(3).normal(size=acc.shape).astype(np.float32)
    ref = np.asarray(PS._sorted_bwd_call(
        gd_t, cnt_t, acc, jnp.asarray(g8), TILES_X, 4, CAP // PS.NBS,
        axis=axis, exit_t=exit_t)).T
    _, chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, TILES_X, axis=axis,
                                              exit_t=exit_t)
    assert chunks.tolist() == [1, 2, 1, 0]
    before = sorted_bwd.launches
    out = sorted_bwd.sorted_bwd(gdense, cnt, torch.from_numpy(np.array(acc)),
                                torch.from_numpy(g8), chunks, TILES_X, axis)
    assert sorted_bwd.launches == before       # no kernel launched on CPU
    out = out.numpy()
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-30)
    bad = np.abs(out - ref) > 2e-3 * np.abs(ref) + 2e-4 * scale
    assert not bad.any(), (
        f"{int(bad.sum())} values off; columns {sorted(set(np.where(bad)[1]))}")
    rows = out.reshape(4, CAP, 16)
    assert not rows[0, 512:].any() and not rows[3].any()
    assert rows[1, 1000].any() and not rows[2, 900:].any()
    if axis:
        assert not out[:, 3].any()             # Mxy of the axis footprint


def test_moment_postpass_matches_jax():
    rng = np.random.default_rng(4)
    gdense = rng.normal(size=(300, 16)).astype(np.float32)
    gdense[::7, 5] = 0.0                       # dead slots: g_op = 0
    raw = rng.normal(size=(300, 16)).astype(np.float32)
    ref = np.asarray(PS.moment_postpass_t(jnp.asarray(gdense.T),
                                          jnp.asarray(raw.T))).T
    got = tsorted.moment_postpass(torch.from_numpy(gdense),
                                  torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_wrapper_contract():
    gdense, cnt = synthetic_lists(True)
    acc, chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, TILES_X)
    g8 = torch.ones_like(acc)
    meta = [t.to("meta") for t in (gdense, cnt, acc, g8, chunks)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        sorted_bwd.sorted_bwd(*meta, TILES_X)
    with pytest.raises(ValueError, match="g8"):
        sorted_bwd.sorted_bwd(gdense, cnt, acc, g8[:, :-1], chunks, TILES_X)
    with pytest.raises(ValueError, match="chunks_done"):
        sorted_bwd.sorted_bwd(gdense, cnt, acc, g8, chunks.long(), TILES_X)


def sorted_loss(render_fn, lib, wi, wa):
    def f(g, view, proj):
        img, alpha, _ = render_fn(g, view, proj)
        return lib.sum(img * wi) + lib.sum(alpha * wa)
    return f


@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("seed,n", [(0, 40), (1, 200), (7, 513)])
def test_sorted_grads_match_jax(seed, n, footprint):
    """The scenes and tolerance of tests/test_sorted_vjp.py:32-50."""
    w, h = 64, 48
    ewa = footprint == "ewa"
    jg, tg = scene(n, seed, quats=ewa)
    rng = np.random.default_rng(seed + 100)
    wi = rng.normal(size=(h, w, 3)).astype(np.float32)
    wa = rng.normal(size=(h, w)).astype(np.float32)
    kw = dict(width=w, height=h, mode="sorted", footprint=footprint)
    jc = jcam.orbit_cameras(1, w, h)[0]
    j_cfg = JConfig(impl="pallas", **kw)
    j_loss = sorted_loss(
        lambda g, v, p: jdispatch.render_sorted(g, v, p, j_cfg), jnp,
        jnp.asarray(wi), jnp.asarray(wa))
    j_grads = jax.grad(j_loss)(jg, jc.view, jc.proj)

    tc = tcam.orbit_cameras(1, w, h, device="cpu")[0]
    t_cfg = TConfig(impl="tiled", **kw)
    fields = FIELDS + (("quats",) if ewa else ())
    for f in fields:
        getattr(tg, f).requires_grad_(True)
    sorted_loss(lambda g, v, p: tdispatch.render_sorted(g, v, p, t_cfg),
                torch, torch.from_numpy(wi), torch.from_numpy(wa))(
        tg, tc.view, tc.proj).backward()
    for f in fields:
        assert_grads_close(getattr(tg, f).grad.numpy(),
                           np.asarray(getattr(j_grads, f)), f)


def test_sorted_grad_finite_difference():
    """The port alone against central differences of its own forward
    (tests/test_sorted_vjp.py:53-74)."""
    _, tg = scene(24, 3)
    c = tcam.orbit_cameras(1, 32, 32, device="cpu")[0]
    cfg = TConfig(width=32, height=32, mode="sorted", impl="tiled")

    def f(means):
        img = tdispatch.render_sorted(tg.replace(means=means), c.view,
                                      c.proj, cfg)[0]
        return img.sum()

    means = tg.means.clone().requires_grad_(True)
    f(means).backward()
    eps = 1e-3
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for _ in range(4):
            i, d = rng.randint(24), rng.randint(3)
            dm = torch.zeros_like(means)
            dm[i, d] = eps
            fd = float(f(tg.means + dm) - f(tg.means - dm)) / (2 * eps)
            an = float(means.grad[i, d])
            assert abs(fd - an) <= 2e-2 * max(1.0, abs(fd)), (
                f"fd {fd} vs analytic {an} at means[{i},{d}]")

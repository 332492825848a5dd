"""Port parity, the dense EWA route past the band kernels' sizes (TPU K9):
the tile-grid K9a/K9b twins (`kernels.splat_v1`), their staging
(`ops.splat._v1_prep`), the route choice `ops.splat._choose_v2`, and
splat_accumulate(axis=False) with the forward on the bands and the backward
on the tile grid, or both on the tile grid, against `tpu_gaussians` (its
Pallas kernels in interpret mode on the CPU) on identical numpy inputs.
Both sides are forced onto the tile grid at these small sizes: JAX through
its VMEM budget `V2_VMEM_BUDGET`, the port through its two thresholds.

Tolerances:
- K9a's sums: rtol 1e-5 / atol 1e-5 (tests/test_pallas_parity.py:106-113);
- K9b's gradient rows: rtol 2e-4, and atol 2e-5 times the largest
  magnitude of the output column (at least 2e-5), as K6's: they sum
  signed terms that cancel;
- the staging's mask exact;
- splat_accumulate values rtol 1e-4 / atol 1e-5 and the gradients of a
  mean-reduced loss rtol 5e-4 / atol 1e-6 (tests/test_pallas_culling.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.ops.pallas import splat as JS
from tpu_gaussians_torch.kernels import splat_v1
from tpu_gaussians_torch.kernels.splat_v2 import EXP_FLOOR
from tpu_gaussians_torch.ops import splat as TS

from .test_torch_port_cuda import assert_moments_close, synthetic_splats
from .test_torch_port_ewa_accum import NAMES, counted, torch_inputs
from .test_torch_port_sorted_bwd import one_torch_thread  # noqa: F401
from .test_torch_port_sorted_fit import jcommon_inputs

# JAX's v2 temporaries (splat.py:416-419), outside the per-gaussian bytes.
V2_FIXED = 8 * JS.NB2 * JS.TP2 * 4

# n not a multiple of the block (no y-sort), a frame below one 2048-pixel
# tile (tp 1024), and y-sorted gaussians over 5 blocks and 3 tall tiles of
# a 64-pixel-wide frame, with sigmas under 2 pixels: a sparse mask.
V1_CASES = [(300, 40, 64), (200, 24, 40), (2500, 96, 64)]


def ewa_splats(n, height, width, seed):
    """synthetic_splats' columns with a general conic, |b| < 0.9 sqrt(a c);
    sigmas up to 8 pixels, or 2 at n = 2500."""
    cols = list(synthetic_splats(n, height, width, seed=seed,
                                 sigma_max=2.0 if n == 2500 else 8.0))
    rng = np.random.default_rng(seed + 1)
    cols[3] = (rng.uniform(-0.9, 0.9, n) * np.sqrt(cols[2] * cols[4])
               ).astype(np.float32)
    return tuple(cols)


def force_budget(monkeypatch, budget: int) -> None:
    """Give JAX the VMEM budget `budget` and the port the thresholds that
    `_v2_fits` derives from it."""
    monkeypatch.setattr(JS, "V2_VMEM_BUDGET", budget)
    monkeypatch.setattr(TS, "V2_MAX_N_PAD_FWD", (budget - V2_FIXED) // 64)
    monkeypatch.setattr(TS, "V2_MAX_N_PAD_BWD", (budget - V2_FIXED) // 128)


def staged(n, height, width):
    cols = ewa_splats(n, height, width, seed=n + 7)
    return cols, TS._v1_prep(TS.y_sorted(torch_inputs(cols)), height, width)


@pytest.mark.parametrize("n,height,width", V1_CASES)
def test_v1_twins_match_tpu_kernels(n, height, width):
    """K9a/K9b twins against _fwd_call / _bwd_call on the port's staging,
    the mask bit-packed by JAX's own _pack_mask_bits; the staging's mask
    against JAX's _band_block_mask on the same padded columns."""
    _, (mask, gdata, nb, tp, hw_pad) = staged(n, height, width)
    assert (nb, tp) == JS._tile_sizes(n, height * width)
    assert hw_pad == JS._round_up(height * width, tp)
    g = jnp.asarray(gdata.numpy())
    sy = JS._sigma_y_from_conic(g[:, 2], g[:, 3], g[:, 4])
    want_mask = JS._band_block_mask(g[:, 1], sy, g[:, 5], hw_pad // tp, tp,
                                    nb, width)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    if n == 2500:
        assert not mask.all()                  # the cull skips pairs

    packed = JS._pack_mask_bits(jnp.asarray(mask.numpy().astype(np.int32)))
    cols = [g[:, k:k + 1] for k in range(6)]
    feats = g[:, 6:14]
    ref = np.asarray(JS._fwd_call(packed, *cols, feats.T, hw_pad, width, nb,
                                  tp))
    before = dict(splat_v1.launches)
    acc = splat_v1.splat_v1_fwd(mask, gdata, hw_pad, width, nb, tp)
    np.testing.assert_allclose(acc.numpy(), ref, rtol=1e-5, atol=1e-5)

    g8 = np.zeros((8, hw_pad), np.float32)
    g8[:5, :height * width] = np.random.default_rng(n).normal(
        size=(5, height * width))
    ref_b = np.asarray(JS._bwd_call(packed, *cols, feats, jnp.asarray(g8),
                                    jnp.asarray(g8.T), hw_pad, width, nb,
                                    tp))
    out = splat_v1.splat_v1_bwd(mask, gdata, torch.from_numpy(g8), hw_pad,
                                width, nb, tp)
    assert splat_v1.launches == before         # no kernel launched on CPU
    assert_moments_close(out.numpy(), ref_b)
    assert not out[:, 14:].any()


def test_v1_wrapper_contract():
    _, (mask, gdata, nb, tp, hw_pad) = staged(300, 40, 64)
    g8 = torch.zeros((8, hw_pad))
    with pytest.raises(ValueError, match="cuda or cpu"):
        splat_v1.splat_v1_fwd(mask.to("meta"), gdata.to("meta"), hw_pad, 64,
                              nb, tp)
    with pytest.raises(ValueError, match="uint8"):
        splat_v1.splat_v1_fwd(mask.int(), gdata, hw_pad, 64, nb, tp)
    with pytest.raises(ValueError, match="mask must be"):
        splat_v1.splat_v1_fwd(mask[:, :0], gdata, hw_pad, 64, nb, tp)
    with pytest.raises(ValueError, match="multiples"):
        splat_v1.splat_v1_fwd(mask, gdata, hw_pad, 64, nb, 100)
    with pytest.raises(ValueError, match="g8"):
        splat_v1.splat_v1_bwd(mask, gdata, g8[:, :-1], hw_pad, 64, nb, tp)


@pytest.mark.parametrize("n", [393_216, 393_217, 786_432, 786_433, 1000])
def test_choose_v2_matches_jax(n):
    """The port's thresholds are JAX's _v2_fits arithmetic at its budget,
    so each direction switches route at the same n."""
    assert TS.V2_MAX_N_PAD_FWD == (JS.V2_VMEM_BUDGET - V2_FIXED) // 64
    assert TS.V2_MAX_N_PAD_BWD == (JS.V2_VMEM_BUDGET - V2_FIXED) // 128
    hw = 512 * 512
    nb, tp = JS._tile_sizes(n, hw)
    for backward in (False, True):
        assert TS._choose_v2(n, backward) == JS._choose_v2(
            n, hw, nb, tp, backward=backward)
    assert TS._tile_sizes(n, hw) == (nb, tp)


@pytest.mark.parametrize("n,height,width", [(300, 40, 64), (2500, 96, 64)])
@pytest.mark.parametrize("route", ["mixed", "v1"])
def test_splat_accumulate_v1_values_and_grads_match_jax(
        monkeypatch, route, n, height, width):
    """mixed: the forward on the bands (K5's twin) and the backward on the
    tile grid (K9b's, restaging from the saved columns), as JAX takes them
    between 393,217 and 786,432 gaussians; v1: both on the tile grid, as
    above 786,432."""
    n_pad2 = JS._round_up(n, JS.NB2)
    force_budget(monkeypatch, V2_FIXED + 64 * n_pad2 if route == "mixed"
                 else 0)
    assert TS._choose_v2(n, backward=False) == (route == "mixed")
    assert not TS._choose_v2(n, backward=True)

    cols = ewa_splats(n, height, width, seed=n + 3)
    g_out = np.random.default_rng(n).normal(
        size=(height * width, 5)).astype(np.float32)
    base_j = jcommon_inputs(cols)._asdict()

    def f_jax(*leaves):
        s = JS.SplatInputs(**{**base_j, **dict(zip(NAMES, leaves))})
        acc = JS.splat_accumulate(s, height, width, axis=False)
        return jnp.mean(acc * g_out), acc

    (_, j_acc), j_grads = jax.jit(jax.value_and_grad(
        f_jax, argnums=tuple(range(len(NAMES))), has_aux=True))(
            *(base_j[k] for k in NAMES))

    calls = []
    for name in ("splat_v1_fwd", "splat_v1_bwd", "splat_v2_fwd",
                 "splat_v2_bwd"):
        counted(monkeypatch, TS, name, calls)
    s = torch_inputs(cols)
    s = s._replace(**{k: getattr(s, k).clone().requires_grad_(True)
                      for k in NAMES})
    t_acc = TS.splat_accumulate(s, height, width, axis=False)
    (t_acc * torch.from_numpy(g_out)).mean().backward()
    assert calls == ["splat_v2_fwd" if route == "mixed" else "splat_v1_fwd",
                     "splat_v1_bwd"]
    np.testing.assert_allclose(t_acc.detach().numpy(), np.asarray(j_acc),
                               rtol=1e-4, atol=1e-5)
    for k, jg in zip(NAMES, j_grads):
        np.testing.assert_allclose(getattr(s, k).grad.numpy(), np.asarray(jg),
                                   rtol=5e-4, atol=1e-6,
                                   err_msg=f"grad of {k}")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its 13 low mantissa bits cleared: the TF32 part of an f32
    value, as K9a forms it and as the tensor core reads an f32 register."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def k9a_emulated(mask, gdata, hw_pad, width, nb, tp):
    """K9a's arithmetic (csrc/splat_v1_fwd.cu) in torch: log2(e) folded
    into the conic and w = 2^e; op folded into the feature rows; the
    product of w and the feature rows from three TF32 products, big.big' +
    big.small' + small.big' with x = big + small (big = tf32(x), small read
    to TF32), each exact (f64) and summed over a 128-row chunk, rounded to
    f32 once per chunk; the chunk partials added into an f32 total per
    pixel in chunk order."""
    log2e = 1.4426950408889634
    out = torch.zeros((8, hw_pad), dtype=torch.float32)
    for i in range(mask.shape[0]):
        idx = i * tp + torch.arange(tp)
        gx = (idx % width).float()[None, :] + 0.5
        gy = (idx // width).float()[None, :] + 0.5
        for j in torch.nonzero(mask[i]).flatten().tolist():
            for c in range(j * nb, (j + 1) * nb, 128):
                g = gdata[c:c + 128]
                ah = (-0.5 * log2e) * g[:, 2:3]
                bh = -log2e * g[:, 3:4]
                ch = (-0.5 * log2e) * g[:, 4:5]
                dx = gx - g[:, 0:1]
                dy = gy - g[:, 1:2]
                e = dx * (ah * dx + bh * dy) + (ch * dy) * dy
                w = torch.exp2(torch.clamp(e, min=EXP_FLOOR * log2e))
                featop = g[:, 6:14] * g[:, 5:6]
                wb, fb = tf32(w), tf32(featop)
                ws, fs = tf32(w - wb), tf32(featop - fb)
                part = (fb.double().T @ wb.double() + fs.double().T
                        @ wb.double() + fb.double().T @ ws.double())
                out[:, i * tp:(i + 1) * tp] += part.float()
    return out


def heavy_inputs(n=2048, height=32, width=64, seed=11):
    """One 2048-pixel tile under 2048 wide gaussians (sigmas 20-40 pixels),
    every block active: each pixel sums every gaussian, and the sums of the
    feature row of ones reach the 1M-gaussian scene's (about 900)."""
    rng = np.random.default_rng(seed)
    sx, sy = rng.uniform(20.0, 40.0, (2, n))
    gd = np.zeros((n, 16), np.float32)
    gd[:, 0] = rng.uniform(0, width, n)
    gd[:, 1] = rng.uniform(0, height, n)
    gd[:, 2], gd[:, 4] = 1.0 / sx ** 2, 1.0 / sy ** 2
    gd[:, 3] = rng.uniform(-0.9, 0.9, n) * np.sqrt(gd[:, 2] * gd[:, 4])
    gd[:, 5] = rng.uniform(0.45, 0.7, n)
    gd[:, 6:9] = rng.uniform(0, 1, (n, 3))
    gd[:, 9] = 1.0
    gd[:, 10] = rng.uniform(2.0, 4.0, n)
    nb, tp = 512, 2048
    mask = torch.ones((1, n // nb), dtype=torch.uint8)
    return mask, torch.from_numpy(gd), nb, tp, tp


@pytest.mark.parametrize("case", [*(f"{n}_{h}x{w}" for n, h, w in V1_CASES),
                                  "heavy_2048_32x64"])
def test_k9a_tf32_split_arithmetic_matches_twin(case):
    """K9a's arithmetic, emulated without a card (the three-way TF32 split
    with op folded into the feature rows, 2^e, chunk partials), against the
    twin at chip_smoke's K9a tolerance, rtol 1e-5 / atol 1e-5: on the parity
    inputs, and on sums of the 1M scene's magnitude."""
    if case.startswith("heavy"):
        mask, gdata, nb, tp, hw_pad = heavy_inputs()
        width = 64
    else:
        n, height, width = map(int, case.replace("x", "_").split("_"))
        _, (mask, gdata, nb, tp, hw_pad) = staged(n, height, width)
    got = k9a_emulated(mask, gdata, hw_pad, width, nb, tp)
    ref = splat_v1.v1_fwd_plain(mask, gdata, hw_pad, width, nb, tp)
    if case.startswith("heavy"):
        assert 800 < float(ref[3].max()) < 1000
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)

"""The per-gaussian stage's autograd Function on the CPU (kernels/stage.py),
torch only: its forward against the stage's composition as
`ops.common.prepare_splats` wrote it before the Function (bit for bit),
its backward (`stage_bwd_plain`, the plain twin of the CUDA kernel's
hand-derived formulas) against torch.autograd through that composition,
on random scenes of every footprint and colour kind and on inputs placed
on each clamp's and branch's boundary; and the wrapper's refusals.

Gradient tolerance: rtol 1e-5 and atol 1e-5 times the largest magnitude of
the gaussian's own reference gradient of that leaf: the same f32 formulas
summed in another order; the chain through det = m00 m11 - m01^2 rounds
relative to its terms, not to the result, and a gaussian near the camera
plane has gradients many orders above the others'."""

import itertools

import numpy as np
import pytest
import torch

from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import Gaussians
from tpu_gaussians_torch.kernels import stage as kstage
from tpu_gaussians_torch.ops.common import prepare_splats
from tpu_gaussians_torch.ops.ewa import axis_aligned_conic, ewa_conic
from tpu_gaussians_torch.ops.projection import project
from tpu_gaussians_torch.ops.sh import eval_colors

W, H = 64, 48
N = 200
LEAVES = ("means", "scales", "quats", "colors", "opacities")


def old_stage(g: Gaussians, view, proj, footprint):
    """The stage as prepare_splats composed it before the Function."""
    s = project(g.means, view, proj, W, H, g.scales)
    colors = torch.clamp(eval_colors(g.sh if g.use_sh else g.colors,
                                     g.means, view), 0.0, 1.0)
    if footprint == "ewa":
        quats = g.quats
        if quats is None:
            quats = torch.zeros((g.capacity, 4), dtype=torch.float32)
            quats[:, 0] = 1.0
        conic = ewa_conic(g.means, g.scales, quats, view, proj, W, H)
    else:
        conic = axis_aligned_conic(s.sigma_x, s.sigma_y)
    op_eff = torch.clamp(g.opacities, min=0.0) * s.valid * g.alive_mask()
    feats = torch.cat([colors, torch.ones_like(s.z_abs)[:, None],
                       s.z_abs[:, None]], dim=1)
    return (s.px, s.py, conic.a, conic.b, conic.c, conic.sigma_x,
            conic.sigma_y, op_eff, feats)


def camera():
    c = tcam.orbit_cameras(3, W, H, device="cpu")
    return c.view[1], c.proj[1]


def scene(sh_k, quats, seed=0, n=N):
    """Arrays of a random scene around the orbit's centre: colours and SH
    DC past [0, 1] on both sides, signed scales, opacities down to -0.3,
    a fifth of the gaussians dead."""
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.8, 0.8, (n, 3)),
        scales=rng.uniform(0.01, 0.3, (n, 3)) * rng.choice([-1, 1], (n, 3)),
        opacities=rng.uniform(-0.3, 1.0, n),
        alive=(rng.uniform(size=n) < 0.8))
    if sh_k:
        sh = rng.normal(0.0, 0.3, (n, sh_k, 3))
        sh[:, 0] = rng.uniform(-0.2, 1.2, (n, 3))
        arr["sh"] = sh
    else:
        arr["colors"] = rng.uniform(-0.2, 1.2, (n, 3))
    if quats:
        arr["quats"] = rng.normal(size=(n, 4))
    return {k: np.asarray(v, np.float32) for k, v in arr.items()}


def gaussians(arr, grad):
    t = {k: torch.from_numpy(v.copy()).requires_grad_(grad and k != "alive")
         for k, v in arr.items()}
    return Gaussians(**t)


def leaf_grads(g: Gaussians):
    return {k: getattr(g, "sh" if k == "colors" and g.use_sh else k).grad
            for k in LEAVES
            if getattr(g, "sh" if k == "colors" and g.use_sh else k)
            is not None}


def run_both(arr, footprint, used=range(9), seed=1):
    """Each side's outputs and leaf gradients under one random cotangent of
    the outputs in `used` (the others unused: None cotangents)."""
    view, proj = camera()
    got = []
    for fn in (lambda g: prepare_splats(g, view, proj, W, H, footprint),
               lambda g: old_stage(g, view, proj, footprint)):
        g = gaussians(arr, grad=True)
        outs = fn(g)
        rng_k = np.random.default_rng(seed)
        loss = sum((outs[k] * torch.from_numpy(rng_k.normal(
            size=tuple(outs[k].shape)).astype(np.float32))).sum()
            for k in used)
        loss.backward()
        got.append(([o.detach() for o in outs], leaf_grads(g)))
    return got


def assert_grads_close(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if ref[k] is None:    # autograd reached no use of the leaf: zero
            assert got[k] is None or not got[k].any(), k
            continue
        n = ref[k].shape[0]
        scale = ref[k].abs().reshape(n, -1).amax(dim=1)
        scale = scale.reshape((n,) + (1,) * (ref[k].ndim - 1))
        assert torch.all((got[k] - ref[k]).abs()
                         <= 1e-5 * ref[k].abs() + 1e-5 * scale), k


KINDS = [(fp, sh_k, quats) for fp, sh_k, quats in itertools.product(
    ("axis", "ewa"), (0, 4, 9, 16), (True, False))
    if fp == "ewa" or quats]


@pytest.mark.parametrize("footprint,sh_k,quats", KINDS)
def test_forward_is_the_old_composition_bit_for_bit(footprint, sh_k, quats):
    arr = scene(sh_k, quats)
    view, proj = camera()
    new = prepare_splats(gaussians(arr, False), view, proj, W, H, footprint)
    old = old_stage(gaussians(arr, False), view, proj, footprint)
    for name, a, b in zip(new._fields, new, old):
        assert torch.equal(a, b), name
        assert a.is_contiguous(), name
    assert new.px.data_ptr() + 4 * N == new.py.data_ptr()   # rows of one buffer


@pytest.mark.parametrize("footprint,sh_k,quats", KINDS)
def test_backward_matches_autograd(footprint, sh_k, quats):
    (_, got), (_, ref) = run_both(scene(sh_k, quats, seed=2), footprint)
    assert_grads_close(got, ref)


@pytest.mark.parametrize("footprint,used", [
    ("axis", (0, 2, 8)), ("ewa", (1, 3, 7)), ("ewa", (5, 6)), ("ewa", (8,))])
def test_backward_with_unused_outputs(footprint, used):
    """Outputs the loss does not read reach the backward as None
    cotangents, read as zero."""
    (_, got), (_, ref) = run_both(scene(16, True, seed=3), footprint,
                                  used=used)
    assert_grads_close(got, ref)


def boundary_scene(footprint):
    """A scene whose gaussians sit on the stage's boundaries, each case
    checked to be hit: axis sigma at exactly 1.0, RGB at exactly 0 and 1,
    negative opacity, alive 0, off-screen and ndc_z outside [-1, 1] (behind
    the camera), |t_z| < 1e-6 (on the camera plane: m00 past its 1e10
    ceiling), and a long thin splat whose m01 is clamped."""
    view, proj = camera()
    arr = scene(0, True, seed=4, n=16)
    arr["opacities"][:] = 0.5
    arr["alive"][:] = True
    arr["colors"][0] = (0.0, 1.0, 0.5)
    arr["colors"][1] = (1.0, 0.0, -0.25)
    arr["opacities"][2] = -0.4
    arr["alive"][3] = False
    cam = tcam.camera_position_from_view(view).numpy()
    fwd = -view[2, :3].numpy()                   # the camera looks down -z
    right = view[0, :3].numpy()
    up = view[1, :3].numpy()
    arr["means"][4] = cam - 0.5 * fwd            # behind the camera
    arr["means"][5] = cam + 0.3 * right          # on the camera plane
    arr["means"][6] = cam + 1.5 * fwd + 3.0 * right   # off-screen
    # long and thin along the screen's diagonal
    arr["means"][7] = cam + 2.0 * fwd
    arr["scales"][7] = (3.0, 1e-4, 1e-4)
    axis = (right + up) / np.linalg.norm(right + up)
    x = np.array([1.0, 0.0, 0.0])
    half = np.cross(x, axis)
    arr["quats"][7] = np.concatenate([[1.0 + x @ axis], half])
    arr = {k: np.asarray(v, np.float32) for k, v in arr.items()}
    # axis sigma_x exactly 1.0 for gaussian 8: step its scale by ulps
    s = torch.from_numpy(arr["scales"][8:9, 0].copy())
    z = project(torch.from_numpy(arr["means"]), view, proj, W, H,
                torch.from_numpy(arr["scales"])).z_abs[8:9]
    s = z / (0.5 * W * proj[0, 0].abs())
    for _ in range(64):
        u = s.abs() * 0.5 * W * proj[0, 0].abs() / z
        if float(u) == 1.0:
            break
        s = torch.nextafter(s, s + (1.0 - u))
    arr["scales"][8, 0] = float(s)
    return arr


@pytest.mark.parametrize("footprint", ["axis", "ewa"])
def test_backward_on_the_boundaries(footprint):
    arr = boundary_scene(footprint)
    view, proj = camera()
    g = gaussians(arr, False)
    s = project(g.means, view, proj, W, H, g.scales)
    p_cam = torch.cat([g.means, torch.ones(16, 1)], 1) @ view.T
    ndc_z = (p_cam @ proj.T)[:, 2] / (p_cam @ proj.T)[:, 3]
    assert not ndc_z[4].abs() <= 1 and s.valid[4] == 0
    assert p_cam[5, 2].abs() < 1e-6
    assert s.px[6] > W
    if footprint == "axis":
        assert float(s.sigma_x[8]) == 1.0
        assert float((g.scales[8, 0].abs() * 0.5 * W * proj[0, 0].abs()
                      / s.z_abs[8])) == 1.0
    else:
        from tpu_gaussians_torch.ops.ewa import ewa_cov2d
        e = ewa_cov2d(g.means, g.scales, g.quats, view, proj, W, H)
        assert e.m00[5] > 1e10                   # the ceiling clamps
        m00 = torch.clamp(e.m00, 1e-8, 1e10)
        m11 = torch.clamp(e.m11, 1e-8, 1e10)
        assert e.m01[7].abs() > 0.999 * torch.sqrt(m00[7] * m11[7])
    (outs, got), (_, ref) = run_both(arr, footprint, seed=5)
    assert outs[8][0, 0] == 0.0 and outs[8][0, 1] == 1.0
    assert outs[7][2] == 0.0 and outs[7][3] == 0.0
    assert_grads_close(got, ref)
    assert got["opacities"][2] == 0.0 and got["opacities"][3] == 0.0
    assert got["colors"][0, 0] != 0.0 and got["colors"][0, 1] != 0.0
    assert got["colors"][1, 2] == 0.0


def refused(**kw):
    arr = scene(4, True, n=8)
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    args = dict(means=t["means"], scales=t["scales"], quats=t["quats"],
                colors=t["sh"], opacities=t["opacities"],
                alive=t["alive"].float(), view=camera()[0],
                proj=camera()[1], width=W, height=H, ewa=True)
    args.update({k: v(args) for k, v in kw.items()})
    return args


@pytest.mark.parametrize("name,change", [
    ("view", lambda a: a["view"].clone().requires_grad_(True)),
    ("proj", lambda a: a["proj"].clone().requires_grad_(True)),
    ("alive", lambda a: a["alive"].clone().requires_grad_(True)),
    ("colors", lambda a: a["colors"][:, :3]),
    ("means", lambda a: a["means"].double()),
    ("scales", lambda a: a["scales"].t().contiguous().t()),
    ("quats", lambda a: a["quats"][:4]),
    ("view", lambda a: a["view"][:3]),
])
def test_the_wrapper_refuses(name, change):
    with pytest.raises(ValueError, match=name):
        kstage.stage(**refused(**{name: change}))

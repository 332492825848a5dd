"""Port parity for two paths no other port test reaches (CPU):

- 3DGS real spherical harmonics, `sh_degree` 2 and 3 (9 and 16 coefficient
  rows): the rendered image and alpha of `tpu_gaussians_torch` against
  `tpu_gaussians` in sorted and accum modes, with both footprints and both
  implementation pairs (the port's kernel twins against the Pallas kernels
  in interpret mode, and the plain renderers). Both sides evaluate the same
  f32 polynomial; the largest difference measured was 3.6e-7 (7.2e-7 in
  the re-anchor's check), so the tolerance is atol 2e-6 with rtol 1e-5.
- `--init_npz`: an npz written by the JAX package, loaded by each package
  and turned into raw parameters by `raw_from_gaussians`, gives the same
  bits in both; `save_raw_npz` of the same raw parameters writes the same
  arrays within 3e-8 plus one f32 ulp of the value (2^-23 relative): the
  two libraries' sigmoid and softplus differ by at most an ulp, which is
  6e-8 for a colour near 0.6.
"""

import numpy as np
import pytest
import torch

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.core.types import make_gaussians
from tpu_gaussians.io import npz as jnpz
from tpu_gaussians.models import gaussian_model as jmodel
from tpu_gaussians.ops import dispatch as jdispatch
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import RenderConfig as TConfig
from tpu_gaussians_torch.core.types import gaussians_from_numpy
from tpu_gaussians_torch.io import npz as tnpz
from tpu_gaussians_torch.models import gaussian_model as tmodel
from tpu_gaussians_torch.ops import dispatch as tdispatch

W, H = 96, 64
SH_RTOL, SH_ATOL = 1e-5, 2e-6
RAW_ATOL, RAW_RTOL = 3e-8, 2.0 ** -23
FIELDS = ("means", "scales_raw", "opacities_raw", "colors_raw", "sh_raw",
          "alive", "quats_raw")


def scene_arrays(n, seed, sh_rows=0, alive=False):
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, (n,)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32))
    if sh_rows:
        sh = rng.normal(0.0, 0.15, (n, sh_rows, 3)).astype(np.float32)
        sh[:, 0] = rng.uniform(-1.0, 1.0, (n, 3))
        arr["sh"] = sh
    else:
        arr["colors"] = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if alive:
        arr["alive"] = (rng.uniform(size=n) < 0.7).astype(np.float32)
    return arr


@pytest.mark.parametrize("impls", [("tiled", "pallas"), ("torch", "jnp")],
                         ids=lambda p: f"{p[0]}-vs-{p[1]}")
@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("mode", ["sorted", "accum"])
@pytest.mark.parametrize("sh_rows", [9, 16], ids=["deg2", "deg3"])
def test_sh_render_matches_reference(sh_rows, mode, footprint, impls):
    arr = scene_arrays(300, sh_rows, sh_rows)
    kw = dict(width=W, height=H, mode=mode, footprint=footprint,
              return_aux=True)
    j_out = jdispatch.render(make_gaussians(**arr),
                             jcam.orbit_cameras(4, W, H)[1],
                             JConfig(impl=impls[1], **kw))
    with torch.no_grad():
        t_out = tdispatch.render(gaussians_from_numpy(arr, device="cpu"),
                                 tcam.orbit_cameras(4, W, H,
                                                    device="cpu")[1],
                                 TConfig(impl=impls[0], **kw))
    for t, j in zip(t_out[:2], j_out[:2]):
        assert t.shape == tuple(j.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=SH_RTOL,
                                   atol=SH_ATOL)
    assert float(t_out[1].max()) > 0.5    # the scene covers the frame


@pytest.mark.parametrize("sh_rows", [0, 4, 16], ids=["rgb", "sh4", "sh16"])
def test_init_npz_raw_params_bit_identical(tmp_path, sh_rows):
    arr = scene_arrays(200, 10 + sh_rows, sh_rows, alive=True)
    path = tmp_path / "init.npz"
    jnpz.save_gaussians_npz(path, make_gaussians(**arr))
    n_alive = int(arr["alive"].sum())
    capacity = n_alive + 37
    j_raw = jmodel.raw_from_gaussians(jnpz.load_gaussians_npz(path),
                                      capacity)
    t_raw = tmodel.raw_from_gaussians(tnpz.load_gaussians_npz(path,
                                                              device="cpu"),
                                      capacity)
    assert t_raw.capacity == j_raw.capacity == capacity
    assert t_raw.use_sh == j_raw.use_sh == bool(sh_rows)
    for k in FIELDS:
        j, t = getattr(j_raw, k), getattr(t_raw, k)
        assert (j is None) == (t is None), k
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=k)


@pytest.mark.parametrize("sh_rows", [0, 4, 16], ids=["rgb", "sh4", "sh16"])
def test_save_raw_npz_matches_reference(tmp_path, sh_rows):
    rng = np.random.default_rng(20 + sh_rows)
    c = 150
    raw = dict(
        means=rng.uniform(-1.0, 1.0, (c, 3)).astype(np.float32),
        scales_raw=rng.normal(-3.0, 1.0, (c, 3)).astype(np.float32),
        opacities_raw=rng.normal(0.0, 2.0, (c,)).astype(np.float32),
        alive=(rng.uniform(size=c) < 0.8).astype(np.float32),
        quats_raw=rng.normal(size=(c, 4)).astype(np.float32))
    if sh_rows:
        raw["sh_raw"] = rng.normal(0.0, 0.3, (c, sh_rows, 3)).astype(
            np.float32)
    else:
        raw["colors_raw"] = rng.normal(0.0, 2.0, (c, 3)).astype(np.float32)
    jnpz.save_raw_npz(tmp_path / "j.npz", jmodel.RawParams(**raw))
    tnpz.save_raw_npz(tmp_path / "t.npz",
                      tmodel.raw_from_numpy(raw, device="cpu"))
    j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in j.files:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        np.testing.assert_allclose(t[k], j[k], rtol=RAW_RTOL, atol=RAW_ATOL,
                                   err_msg=k)

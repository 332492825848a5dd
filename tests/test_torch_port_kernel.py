"""Port parity, compositing kernel module: `sorted_tiles_plain` (the CUDA
kernel's plain twin) against the TPU kernel `_sorted_fwd_call` (run in
interpret mode on the CPU, as the JAX suite runs it) on identical per-tile
lists; and the kernel wrapper's device contract.

Tolerance rtol 1e-5 / atol 1e-6: both run the same f32 sub-block algorithm;
the cumprod and the 128-long feature contraction sum in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gaussians.ops.pallas import sorted as PS
from tpu_gaussians_torch.core import camera as tcam
from tpu_gaussians_torch.core.types import gaussians_from_numpy
from tpu_gaussians_torch.kernels import build, sorted_fwd
from tpu_gaussians_torch.ops import sorted as tsorted
from tpu_gaussians_torch.ops.common import prepare_splats
from tpu_gaussians_torch.ops.projection import camera_z

from .test_torch_port_cuda import CAP, TILES_X, synthetic_lists

def tile_inputs(device="cpu", n=300, seed=0):
    """Per-tile lists of a small random scene through the port's binner."""
    rng = np.random.default_rng(seed)
    arr = dict(
        means=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32),
        opacities=rng.uniform(0.5, 0.99, (n,)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    g = gaussians_from_numpy(arr, device=device)
    c = tcam.orbit_cameras(4, 128, 64, device=device)[1]
    s = prepare_splats(g, c.view, c.proj, 128, 64)
    gdense, cnt, tiles_x, _, _ = tsorted.tile_lists(
        s, camera_z(g.means, c.view), 64, 128, band_capacity=512, pair_k=8)
    return gdense, cnt, tiles_x


@pytest.mark.parametrize("footprint", ["axis", "ewa"])
@pytest.mark.parametrize("exit_t", [1e-6, 1e-3])
def test_plain_twin_matches_tpu_kernel(footprint, exit_t):
    axis = footprint == "axis"
    gdense, cnt = synthetic_lists(axis)
    acc, chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, TILES_X,
                                                axis=axis, exit_t=exit_t)
    ref = PS._sorted_fwd_call(
        jnp.asarray(gdense.numpy().T), jnp.asarray(cnt.numpy()[None, :]),
        TILES_X, cnt.shape[0], CAP // PS.NBS, axis=axis, exit_t=exit_t)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # tile 0 exits after its first chunk; the translucent tile 1 runs on
    np.testing.assert_array_equal(chunks.numpy()[:2], [1, 2])


def test_wrapper_takes_plain_twin_on_cpu_only():
    gdense, cnt, tiles_x = tile_inputs()
    before = sorted_fwd.launches
    acc, chunks = sorted_fwd.sorted_tiles(gdense, cnt, tiles_x, axis=True)
    ref, ref_chunks = sorted_fwd.sorted_tiles_plain(gdense, cnt, tiles_x,
                                                    axis=True)
    assert torch.equal(acc, ref) and torch.equal(chunks, ref_chunks)
    assert sorted_fwd.launches == before      # no kernel launched on CPU
    meta = gdense.to("meta"), cnt.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sorted_fwd.sorted_tiles(*meta, tiles_x)
    with pytest.raises(ValueError):
        sorted_fwd.sorted_tiles(gdense[:-1], cnt, tiles_x)
    with pytest.raises(ValueError):
        sorted_fwd.sorted_tiles(gdense, cnt.to(torch.int64), tiles_x)


def test_kernel_build_needs_nvcc():
    """No CUDA toolchain here: the kernel path raises instead of
    substituting anything."""
    if build.shutil.which("nvcc") or build.os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: this checks the no-toolchain refusal")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all(["sorted_fwd"])
    assert build.library_path("sorted_fwd").name.startswith("sorted_fwd-")

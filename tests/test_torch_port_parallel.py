"""Port parity, the parallel modules: `tpu_gaussians_torch.parallel`'s mesh
and sharded steps over two gloo ranks on the CPU against
`tpu_gaussians.parallel` and the JAX single-device step on the same numpy
inputs (tests/test_sharded.py's setup, 8 views and 24 of 32 gaussians, at
16x32 rather than 16x16: the rows mesh's two bands are then one 16-row tile
each, parallel/mesh.band_rows).

The two ranks are processes of their own (tests/torch_port_rank_worker.py,
which imports no JAX), joined through a FileStore under the test's
temporary directory; each runs every case once, and every wait has its
own timeout. Tolerances are tests/test_sharded.py's _assert_states_match:
loss rtol 1e-5 / atol 1e-6, every leaf rtol 2e-4 / atol 2e-6. The JAX
reference takes its jnp path (impl "jnp"); the port's kernel wrappers
(impl "tiled", their plain twins on the CPU) are held against the port's
own single-rank step."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_gaussians.core import camera as jcam
from tpu_gaussians.core.types import RenderConfig as JConfig
from tpu_gaussians.fit.loss import LossConfig as JLoss
from tpu_gaussians.fit.step import init_state, make_optimizer, make_train_step
from tpu_gaussians.fit.trainer import fit as jfit
from tpu_gaussians.models.gaussian_model import init_params
from tpu_gaussians.parallel import mesh as jmesh
from tpu_gaussians.utils.config import FitConfig as JFitConfig
from tpu_gaussians_torch.parallel import mesh as tmesh

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_port_rank_worker.py")
W, H = 16, 32   # two row bands of one 16-row tile each
V = 8
RANKS = 2
WAIT_S = 150
LEAVES = ("means", "scales_raw", "opacities_raw", "colors_raw")
FACTORIES = ("sharded", "shardmap", "overlapped1", "overlapped2",
             "overlapped4")


def raw_arrays(raw):
    return {f: np.asarray(getattr(raw, f)) for f in
            ("means", "scales_raw", "opacities_raw", "colors_raw", "alive")
            if getattr(raw, f) is not None}


def fit_base():
    return dict(iters=6, width=W, height=H, num_gaussians=16,
                max_gaussians=24, densify_interval=1000, prune_interval=1000,
                impl="jnp", silhouette_weight=0.0, log_every=1000, seed=4)


@pytest.fixture(scope="module")
def inputs():
    raw = init_params(jax.random.PRNGKey(0), 24, 32)
    _, k_init = jax.random.split(jax.random.PRNGKey(fit_base()["seed"]))
    fit_raw = init_params(k_init, 16, 24, False)
    return {
        **{f"raw/{k}": v for k, v in raw_arrays(raw).items()},
        **{f"fit_raw/{k}": v for k, v in raw_arrays(fit_raw).items()},
        "targets": np.random.default_rng(0).uniform(
            size=(V, H, W, 3)).astype(np.float32),
        "fit_targets": np.random.default_rng(1).uniform(
            size=(V, H, W, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def ranks(inputs, rank_dir):
    """Each rank's results (the worker's npz), after both exited 0."""
    d = rank_dir
    np.savez(d / "in.npz", **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(d / "store"), str(r), str(RANKS),
         str(d / "in.npz"), str(d)], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_single(inputs):
    """The JAX single-device step (jnp path), SSIM off and on."""
    raw = init_params(jax.random.PRNGKey(0), 24, 32)
    cams = jcam.orbit_cameras(V, W, H)
    targets = inputs["targets"]
    zeros = np.zeros((V, H, W), np.float32)
    rc = JConfig(width=W, height=H, impl="jnp", chunk_size=8,
                 return_aux=True)
    tx = make_optimizer(0.02)
    out = {}
    for ssim in (0.0, 0.2):
        step = make_train_step(tx, rc, JLoss(ssim_weight=ssim), False, False,
                               donate=False)
        out[ssim] = step(init_state(raw, tx), cams, targets, zeros, zeros)
    return out


def assert_states_match(res, case, ref_leaves, ref_loss):
    np.testing.assert_allclose(float(res[f"{case}/metric/loss"]),
                               float(ref_loss), rtol=1e-5, atol=1e-6)
    for leaf in LEAVES:
        np.testing.assert_allclose(res[f"{case}/{leaf}"], ref_leaves[leaf],
                                   rtol=2e-4, atol=2e-6, err_msg=leaf)


def test_input_sharding_layout(ranks, inputs):
    """Each rank holds exactly its views (and, on the rows mesh, its rows),
    the blocks JAX places on the same mesh's devices."""
    targets = inputs["targets"]
    jtargets = jax.device_put(targets, jmesh.view_sharding(
        jmesh.make_mesh(2, 1, devices=jax.devices()[:2]), 4))
    shards = {s.device: np.asarray(s.data)
              for s in jtargets.addressable_shards}
    for r, res in enumerate(ranks):
        assert res["layout/targets"].shape == (V // RANKS, H, W, 3)
        np.testing.assert_array_equal(res["layout/targets"],
                                      shards[jax.devices()[r]])
        np.testing.assert_array_equal(
            res["layout/rows"], targets[:, r * H // 2:(r + 1) * H // 2])
        np.testing.assert_array_equal(res["layout/replicated"], targets)


def test_mesh_needs_enough_ranks():
    with pytest.raises(ValueError) as t_err:
        tmesh.make_mesh(2, 1)
    with pytest.raises(ValueError) as j_err:
        jmesh.make_mesh(2, 1, devices=jax.devices()[:1])
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("ssim", [0.0, 0.2])
@pytest.mark.parametrize("mesh", ["views", "rows"])
@pytest.mark.parametrize("factory", FACTORIES)
def test_step_matches_single_device(ranks, jax_single, factory, mesh, ssim):
    """Views 2x1 and rows 1x2 (the sharded step renders row windows
    there), against JAX's single-device step and the factory's own
    single-rank step; the metrics as the single-device step's."""
    res = ranks[0]
    case = f"{factory}/{mesh}/ssim{ssim}"
    s1, m1 = jax_single[ssim]
    assert_states_match(res, case, {k: np.asarray(getattr(s1.raw, k))
                                    for k in LEAVES}, m1["loss"])
    single = f"{factory}/single/ssim{ssim}"
    assert_states_match(res, case, {k: res[f"{single}/{k}"] for k in LEAVES},
                        res[f"{single}/metric/loss"])
    for k in ("recon", "ssim", "psnr", "reg", "n_alive"):
        np.testing.assert_allclose(res[f"{case}/metric/{k}"],
                                   np.asarray(m1[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("factory", ["sharded", "shardmap"])
@pytest.mark.parametrize("mode,binned", [("accum", "off"), ("accum", "on"),
                                         ("sorted", "off")])
def test_kernel_wrappers_step_matches_single(ranks, mode, binned, factory):
    """The kernel wrappers (impl "tiled") under the sharded steps, in
    tests/test_sharded.py's three _PALLAS_CONFIGS modes, against the same
    step on one rank."""
    res = ranks[0]
    case = f"tiled_{mode}_{binned}/{factory}"
    assert_states_match(res, f"{case}/views",
                        {k: res[f"{case}/single/{k}"] for k in LEAVES},
                        res[f"{case}/single/metric/loss"])


def test_ten_sharded_steps_lower_the_loss(ranks):
    losses = ranks[0]["ten_steps/losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_ranks_hold_bit_identical_parameters(ranks):
    """Adam runs on the same reduced gradients on every rank."""
    keys = [k for k in ranks[0] if not k.startswith("layout")]
    assert keys and sorted(keys) == sorted(
        k for k in ranks[1] if not k.startswith("layout"))
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_trainer_num_view_shards(ranks, inputs):
    """fit(num_view_shards=2) over two ranks against JAX's
    fit(num_view_shards=8) from the same initial parameters
    (tests/test_sharded.py::test_trainer_num_view_shards's recipe)."""
    targets = inputs["fit_targets"]
    j_res = jfit(JFitConfig(**{**fit_base(), "num_view_shards": 8}),
                 targets, jcam.orbit_cameras(V, W, H))
    np.testing.assert_allclose(ranks[0]["fit/means"],
                               np.asarray(j_res.raw.means),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(ranks[0]["fit/loss_log"], j_res.loss_log,
                               rtol=1e-5, atol=1e-6)


def test_trainer_resume_and_rank0_writes(ranks, rank_dir):
    """The sharded fit cut at 3 steps and resumed to 6 equals the unbroken
    fit bit for bit on both ranks (each restores rank 0's checkpoint), and
    out_dir holds one rank's metrics: 3 lines, then 3 appended."""
    for res in ranks:
        np.testing.assert_array_equal(res["resume/means"], res["fit/means"])
    fit_dir = rank_dir / "fit_out"
    assert len((fit_dir / "metrics.jsonl").read_text().splitlines()) == 6
    assert sorted(p.name for p in (fit_dir / "checkpoints").iterdir()
                  if not p.name.startswith(".")) == ["3", "6"]


def test_dead_coordinator_fails_loudly():
    """A rank pointed at a coordinator that never comes up fails within
    its timeout with a RuntimeError, not a hang or a one-process run; with
    no arguments and no multi-process environment nothing is brought
    up."""
    code = (
        "import torch.distributed as dist\n"
        "from tpu_gaussians_torch.parallel.mesh import "
        "initialize_distributed\n"
        "initialize_distributed(device='cpu')\n"
        "assert not dist.is_initialized()\n"
        "try:\n"
        "    initialize_distributed('localhost:1', num_processes=2,\n"
        "                           process_id=1, timeout_s=5,\n"
        "                           device='cpu')\n"
        "except RuntimeError as e:\n"
        "    assert 'failed within 5s' in str(e), str(e)\n"
        "    print('LOUD_FAILURE_OK')\n"
        "else:\n"
        "    print('SILENT_DEGRADE_BUG')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=90)
    assert "LOUD_FAILURE_OK" in p.stdout, (p.returncode, p.stdout,
                                           p.stderr[-800:])
    assert time.perf_counter() - t0 < 60

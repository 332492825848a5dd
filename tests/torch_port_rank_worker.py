"""One rank of the port's parallel tests (tests/test_torch_port_parallel.py).

  python tests/torch_port_rank_worker.py STORE RANK WORLD IN.npz OUT_DIR \
      [DEVICE]

Joins a group of WORLD ranks through a FileStore at STORE (gloo; on
DEVICE cuda the ranks share the card, as initialize_distributed's rule
picks), runs every case of the parallel tests on DEVICE (default cpu), and
writes OUT_DIR/rank<RANK>.npz:
each case's parameters after the step ("<case>/<leaf>") and its metrics
("<case>/metric/<name>"). IN.npz holds the inputs, made by the test from
a seed: the initial raw leaves ("raw/<leaf>", "fit_raw/<leaf>"), targets
and the fit's targets. The resumed fit writes OUT_DIR/fit_out. Imports no
JAX.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpu_gaussians_torch.core import camera as cam  # noqa: E402
from tpu_gaussians_torch.core.types import RenderConfig  # noqa: E402
from tpu_gaussians_torch.fit.loss import LossConfig  # noqa: E402
from tpu_gaussians_torch.fit.step import (  # noqa: E402
    init_state, make_optimizer)
from tpu_gaussians_torch.fit.trainer import fit  # noqa: E402
from tpu_gaussians_torch.models.gaussian_model import (  # noqa: E402
    raw_from_numpy)
from tpu_gaussians_torch.parallel import mesh as pmesh  # noqa: E402
from tpu_gaussians_torch.parallel import sharded  # noqa: E402
from tpu_gaussians_torch.utils.config import FitConfig  # noqa: E402

W, H = 16, 32   # two row bands of one 16-row tile each
V = 8
FACTORIES = {
    "sharded": lambda tx, rc, lc, m, rows: sharded.make_sharded_train_step(
        tx, rc, lc, False, False, m, shard_rows=rows),
    "shardmap": lambda tx, rc, lc, m, rows: sharded.make_shardmap_train_step(
        tx, rc, lc, False, False, m),
    **{f"overlapped{k}": (lambda k: lambda tx, rc, lc, m, rows:
                          sharded.make_overlapped_train_step(
                              tx, rc, lc, False, False, m, n_chunks=k))(k)
       for k in (1, 2, 4)},
}
# (mode, accum_binned) of the kernel wrappers (impl "tiled": their plain
# twins on the CPU, the kernels on the card), as tests/test_sharded.py's
# _PALLAS_CONFIGS.
TILED_CONFIGS = (("accum", "off"), ("accum", "on"), ("sorted", "off"))


def leaves_of(prefix: str, inputs) -> dict:
    return {k.split("/", 1)[1]: inputs[k] for k in inputs.files
            if k.startswith(prefix + "/")}


def main() -> None:
    store, rank, world, inp, out = sys.argv[1:6]
    dev = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pmesh.initialize_distributed(f"file://{store}", num_processes=world,
                                 process_id=rank, timeout_s=60, device=dev)
    inputs = np.load(inp)
    raw = raw_from_numpy(leaves_of("raw", inputs), dev)
    cams = cam.orbit_cameras(V, W, H, device=dev)
    targets = torch.from_numpy(inputs["targets"]).to(dev)
    zeros = torch.zeros((V, H, W), device=dev)
    tx = make_optimizer(0.02)
    res = {}

    def record(case, state, metrics):
        for k, t in state.raw.trainable().items():
            res[f"{case}/{k}"] = t.detach().cpu().numpy().copy()
        for k, t in metrics.items():
            res[f"{case}/metric/{k}"] = np.float32(float(t))

    # The layout: each rank holds exactly its views.
    views = pmesh.make_mesh(2, 1)
    rows = pmesh.make_mesh(1, 2)
    local = pmesh.make_mesh(1, 1, ranks=[rank])
    res["layout/targets"] = pmesh.view_sharding(views, 4).local(
        targets).cpu().numpy()
    res["layout/rows"] = pmesh.view_sharding(rows, 4, row_dim=1).local(
        targets).cpu().numpy()
    res["layout/replicated"] = pmesh.replicated(views).local(
        targets).cpu().numpy()

    for ssim in (0.0, 0.2):
        rc = RenderConfig(width=W, height=H, impl="torch", chunk_size=8,
                          return_aux=True)
        lc = LossConfig(ssim_weight=ssim)
        for name, make in FACTORIES.items():
            for mesh_name, mesh in (("views", views), ("rows", rows),
                                    ("single", local)):
                step = make(tx, rc, lc, mesh, mesh_name == "rows")
                record(f"{name}/{mesh_name}/ssim{ssim}",
                       *step(init_state(raw, tx), cams, targets, zeros,
                             zeros))

    for mode, binned in TILED_CONFIGS:
        rc = RenderConfig(width=W, height=H, impl="tiled", chunk_size=8,
                          return_aux=True, mode=mode, accum_binned=binned)
        for name in ("sharded", "shardmap"):
            for mesh_name, mesh in (("views", views), ("single", local)):
                step = FACTORIES[name](tx, rc, LossConfig(), mesh, False)
                record(f"tiled_{mode}_{binned}/{name}/{mesh_name}",
                       *step(init_state(raw, tx), cams, targets, zeros,
                             zeros))

    rc = RenderConfig(width=W, height=H, impl="torch", chunk_size=8,
                      return_aux=True)
    step = sharded.make_sharded_train_step(tx, rc, LossConfig(), False,
                                           False, views)
    state = init_state(raw, tx)
    losses = []
    for _ in range(10):
        state, m = step(state, cams, targets, zeros, zeros)
        losses.append(float(m["loss"]))
    res["ten_steps/losses"] = np.asarray(losses, np.float32)

    fit_targets = inputs["fit_targets"]
    cfg = FitConfig(iters=6, width=W, height=H, num_gaussians=16,
                    max_gaussians=24, densify_interval=1000,
                    prune_interval=1000, impl="torch", silhouette_weight=0.0,
                    log_every=1000, seed=4, num_view_shards=world)
    result = fit(cfg, fit_targets, cam.orbit_cameras(
        fit_targets.shape[0], W, H, device=dev), device=dev,
        raw0=raw_from_numpy(leaves_of("fit_raw", inputs), dev))
    res["fit/means"] = result.raw.means.cpu().numpy()
    res["fit/loss_log"] = np.asarray(result.loss_log, np.float32)
    # The same fit cut at 3 steps and resumed: every rank restores rank
    # 0's checkpoint; rank 0 alone writes out_dir.
    fit_dir = Path(out) / "fit_out"
    for iters, resume in ((3, False), (6, True)):
        resumed = fit(dataclasses.replace(
            cfg, iters=iters, checkpoint_every=3, resume=resume),
            fit_targets, cam.orbit_cameras(fit_targets.shape[0], W, H,
                                           device=dev), device=dev,
            out_dir=fit_dir,
            raw0=raw_from_numpy(leaves_of("fit_raw", inputs), dev))
    res["resume/means"] = resumed.raw.means.cpu().numpy()
    res["allreduce/calls"] = np.int64(sharded.allreduce["calls"])

    np.savez(Path(out) / f"rank{rank}.npz", **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

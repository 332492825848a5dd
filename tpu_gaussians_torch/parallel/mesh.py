"""Process groups and shardings over torch.distributed, as
`tpu_gaussians.parallel.mesh`.

Axis names, as the JAX package's:

  "views" — data parallelism over the multiview batch: each rank renders
            its share of the views and the gradients are averaged (the loss
            is a mean over views)
  "rows"  — spatial parallelism over image rows: each rank renders a row
            window of its views' frames

Where JAX lets GSPMD insert the collectives, the port places them by hand
(parallel/sharded.py): every rank holds the parameters whole, and one
flat all-reduce a step averages the gradients.

The mesh is plain subgroups from `new_group`, not
`torch.distributed.device_mesh.DeviceMesh`: DeviceMesh picks the card
itself from LOCAL_RANK when the process has not set one (a card that does
not exist when several ranks share one card through gloo), brings up a
default group even for a one-rank mesh, and its DTensor layer is not used
here: the steps all-reduce flat buffers themselves. The shardings keep
DTensor's placements (`Shard(dim)`, `Replicate()`) as their description.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from tpu_gaussians_torch.core.types import Device
from tpu_gaussians_torch.ops.binning import TH

VIEW_AXIS = "views"
ROW_AXIS = "rows"


@dataclass(frozen=True)
class Mesh:
    """A (views, rows) grid of global ranks, seen from one process.

    `group` spans every rank of the mesh and `row_group` the ranks that
    share this rank's views (None where that is one rank: no communication
    is needed there). `coords` is this rank's (view, row) index, None when
    the process is not in the mesh.
    """

    grid: Tuple[Tuple[int, ...], ...]
    rank: int
    group: Optional[dist.ProcessGroup]
    row_group: Optional[dist.ProcessGroup]
    axis_names: Tuple[str, str] = (VIEW_AXIS, ROW_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {VIEW_AXIS: len(self.grid), ROW_AXIS: len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def coords(self) -> Optional[Tuple[int, int]]:
        for i, row in enumerate(self.grid):
            if self.rank in row:
                return i, row.index(self.rank)
        return None


def band_rows(height: int, n_bands: int) -> int:
    """Rows of each of n_bands row bands of a frame: ceil(height /
    n_bands) rounded up to whole tile rows (TH), so that each tile of a
    band is one of the frame's tiles (JAX takes ceil(height / n_bands))."""
    return -(-(-(-height // n_bands)) // TH) * TH


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(
    n_view_shards: Optional[int] = None,
    n_row_shards: int = 1,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a (views, rows) mesh over the group's ranks (or `ranks`).
    Defaults to all ranks on the views axis. Every process of the group
    must call it, with the same arguments (it creates subgroups)."""
    rank, world = rank_and_world()
    ranks = list(ranks if ranks is not None else range(world))
    if n_view_shards is None:
        n_view_shards = len(ranks) // n_row_shards
    n = n_view_shards * n_row_shards
    if n > len(ranks):
        raise ValueError(
            f"mesh {n_view_shards}x{n_row_shards} needs {n} devices, "
            f"have {len(ranks)}"
        )
    grid = tuple(tuple(ranks[i * n_row_shards:(i + 1) * n_row_shards])
                 for i in range(n_view_shards))
    group = row_group = None
    if n > 1:
        members = [r for row in grid for r in row]
        group = (dist.group.WORLD if sorted(members) == list(range(world))
                 else dist.new_group(members))
        if n_row_shards > 1:
            for row in grid:      # every process takes part in each call
                g = dist.new_group(list(row))
                if rank in row:
                    row_group = g
    return Mesh(grid=grid, rank=rank, group=group, row_group=row_group)


@dataclass(frozen=True)
class Sharding:
    """Where a global tensor's blocks live on a mesh: one placement per
    mesh axis (views, rows), DTensor's Shard(dim) or Replicate()."""

    mesh: Mesh
    placements: Tuple[object, object]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor `x` (a view, no copy).
        Views split into equal blocks; rows into the row bands the ranks
        render (band_rows: whole tile rows, the last band shorter or
        empty)."""
        coords = self.mesh.coords
        if coords is None:
            raise ValueError(f"rank {self.mesh.rank} is not in the mesh "
                             f"{self.mesh.grid}")
        for index, axis, p in zip(coords, self.mesh.axis_names,
                                  self.placements):
            if isinstance(p, Shard):
                n, size = self.mesh.shape[axis], x.shape[p.dim]
                if axis == ROW_AXIS:
                    block = band_rows(size, n)
                elif size % n:
                    raise ValueError(f"{size} {axis} do not split into {n} "
                                     "equal shards")
                else:
                    block = size // n
                start = min(index * block, size)
                x = x.narrow(p.dim, start, min(block, size - start))
        return x


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (Replicate(), Replicate()))


def view_sharding(mesh: Mesh, rank: int, row_dim: Optional[int] = None
                  ) -> Sharding:
    """Shard axis 0 over views and (optionally) `row_dim` over rows for a
    tensor of the given rank (e.g. targets (V,H,W,3) with row_dim=1)."""
    del rank    # the placements do not depend on it; JAX's signature
    rows = (Shard(row_dim) if row_dim is not None
            and mesh.shape[ROW_AXIS] > 1 else Replicate())
    return Sharding(mesh, (Shard(0), rows))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: float = 120.0,
                           device: Device = "cuda") -> None:
    """Bring up the default process group, loudly and within `timeout_s`.

    With no arguments it acts only when the environment is multi-process
    (WORLD_SIZE > 1, as `torch.distributed.run` sets it) and otherwise
    returns; a second call does nothing. `coordinator` is host:port (or a
    tcp:// or file:// URL) of rank 0's store. On `device` "cuda" each rank
    takes the card LOCAL_RANK % torch.cuda.device_count(); the backend is
    NCCL when every rank of the node has a card of its own, else gloo
    (which stages CUDA tensors through the host), printed once on rank 0.
    A failure, such as a dead or mistyped coordinator, raises RuntimeError.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None and num_processes is None:
        if int(env.get("WORLD_SIZE", "1")) <= 1:
            return                      # single-process run
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        where = (f"env:// ({env.get('MASTER_ADDR')}:"
                 f"{env.get('MASTER_PORT')})")
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("coordinator, num_processes and process_id "
                             "go together")
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
        world, rank = num_processes, process_id
        where = init_method
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend, why = "gloo", "the ranks run on the CPU"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend, why = "nccl", f"a card for each of {local_world} ranks"
        else:
            why = (f"{local_world} ranks share {cards} card(s): NCCL "
                   "refuses two ranks on one card")
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
    except Exception as e:  # noqa: BLE001 (re-raised with context)
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend}, {where}, "
            f"world_size={world}, rank={rank}) failed within "
            f"{timeout_s:.0f}s: check the coordinator address/port and "
            "that every process was launched") from e
    if rank == 0:
        print(f"torch.distributed: {world} ranks, backend {backend} ({why})",
              flush=True)

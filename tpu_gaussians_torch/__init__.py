"""PyTorch + CUDA port of tpu_gaussians for NVIDIA Hopper (H100).

The JAX package `tpu_gaussians` stays the reference; this package keeps its
layout, names and package-level API so each module's counterpart is easy
to find, and never imports it (nor JAX). Every path of the JAX package's
render server (cli.serve), renderer (cli.render) and trainer (cli.fit) is
ported: both render modes, both footprints, the tile-binned and the exact
dense accumulation routes, down to a hand-written CUDA kernel for each of
its Pallas kernels (`csrc/*.cu`); so are its interop (PLY, COLMAP import),
evaluation, checkpoint/resume and debug and profiling modules, the parallel
modules on torch.distributed (views and rows over ranks, row-band frames)
and the binding of the native CPU rasterizer. Not ported: JAX's XLA
compile cache (`utils/cache.py`; kernels/build.py caches the nvcc builds).

Layout:
  core/      Gaussians, Camera, RenderConfig, camera math
  io/        npz (reference schema), 3DGS PLY, COLMAP models, checkpoints,
             image loading and PNG output
  ops/       per-gaussian stage, tile binner, sorted compositing, band,
             tile-grid and tile-binned accumulation, dispatch
  kernels/   nvcc build + ctypes binding, kernel wrappers and plain twins
  csrc/      CUDA C++ kernel sources (sm_90a)
  models/    raw parameters at fixed capacity, activations
  fit/       loss, Adam step, densify/prune, trainer
  parallel/  process groups, sharded train steps, row-band rendering
  native/    ctypes binding of the C++ CPU rasterizer (g++ at first use)
  utils/     FitConfig, debug aids (interpret_mode), profiling
  cli/       fit / serve / render / eval / import_colmap / convert /
             make_cameras / view entry points
"""

from tpu_gaussians_torch.core.types import Camera, Gaussians, RenderConfig
from tpu_gaussians_torch.core import camera
from tpu_gaussians_torch.ops.dispatch import render

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Gaussians",
    "RenderConfig",
    "camera",
    "render",
    "__version__",
]

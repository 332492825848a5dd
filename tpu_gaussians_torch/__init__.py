"""PyTorch + CUDA port of tpu_gaussians for NVIDIA Hopper (H100).

The JAX package `tpu_gaussians` stays the reference; this package keeps its
layout and names so each module's counterpart is easy to find, and never
imports it (nor JAX). Ported so far: the depth-sorted render server
(cli.serve) and renderer (cli.render), down to the per-tile compositing
kernel `csrc/sorted_fwd.cu`; accumulation training (cli.fit) and the
accum render mode, down to the separable band kernels
`csrc/splat_sep_fwd.cu` and `csrc/splat_sep_bwd.cu`.

Layout:
  core/      Gaussians, Camera, RenderConfig, camera math
  io/        npz (reference schema), image loading and PNG output
  ops/       per-gaussian stage, tile binner, sorted compositing, band
             accumulation, dispatch
  kernels/   nvcc build + ctypes binding, kernel wrappers and plain twins
  csrc/      CUDA C++ kernel sources (sm_90a)
  models/    raw parameters at fixed capacity, activations
  fit/       loss, Adam step, densify/prune, trainer
  utils/     FitConfig
  cli/       fit / serve / render entry points
"""

__version__ = "0.1.0"

"""PyTorch + CUDA port of tpu_gaussians for NVIDIA Hopper (H100).

The JAX package `tpu_gaussians` stays the reference; this package keeps its
layout and names so each module's counterpart is easy to find, and never
imports it (nor JAX). Ported so far: the depth-sorted render server
(cli.serve) and renderer (cli.render), down to the per-tile compositing
kernel `csrc/sorted_fwd.cu`.

Layout:
  core/      Gaussians, Camera, RenderConfig, camera math
  io/        npz (reference schema), PNG output
  ops/       per-gaussian stage, tile binner, sorted compositing, dispatch
  kernels/   nvcc build + ctypes binding, kernel wrappers and plain twins
  csrc/      CUDA C++ kernel sources (sm_90a)
  cli/       serve / render entry points
"""

__version__ = "0.1.0"

#!/usr/bin/env python3
"""Measure the two pipes that K9a and K9b share on one card: the tensor
cores through mma.sync.m16n8k8 TF32, the SFU through ex2.approx.ftz.f32,
alone and mixed in K9a's ratio.

  python3 tpu_gaussians_torch/tools/pipe_rates.py

Builds a microbenchmark into `_build/` (nvcc) whose threads each run, per
iteration: 8 independent mma.sync products (hmma), or 16 independent ex2
chains (mufu), or 6 products and 8 exps (mixed: K9a's 24 products and 32
exps per warp and 8-gaussian step, divided by 4). 32 warps an SM, 4096
iterations, CUDA events. Prints one JSON line per mode with the cycles a
warp's iteration holds one SM sub-partition (the SM clock read by
nvidia-smi just after), and the card's name and power limit. Needs one
NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HMMA, int MUFU>
__global__ void rates(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  const uint32_t a[4] = {__float_as_uint(1.0f + lane), 0x3f800000u,
                         0x3f000000u, 0x3e800000u};
  const uint32_t b0 = __float_as_uint(0.5f);
  const uint32_t b1 = __float_as_uint(0.25f + lane);
  float c[8][4] = {};
  float x[16];
  for (int k = 0; k < 16; ++k) x[k] = -0.001f * (k + lane);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < HMMA; ++k) mma(c[k], a, b0, b1);
#pragma unroll
    for (int k = 0; k < MUFU; ++k) x[k] = ex2(x[k]) - 1.0f;
  }
  float s = 0.f;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  for (int k = 0; k < 16; ++k) s += x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int rates_launch(int mode, float* out, int blocks, int threads,
                            int iters) {
  if (mode == 0) rates<8, 0><<<blocks, threads>>>(out, iters);
  if (mode == 1) rates<0, 16><<<blocks, threads>>>(out, iters);
  if (mode == 2) rates<6, 8><<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""
MODES = {"hmma": (0, 8, 0), "mufu": (1, 0, 16), "mixed": (2, 6, 8)}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from tpu_gaussians_torch.kernels import build

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD / "pipe_rates.cu"
    so = cu.with_suffix(".so")
    cu.write_text(SOURCE)
    subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(so), str(cu)],
                   capture_output=True, text=True, timeout=600, check=True)
    fn = ctypes.CDLL(str(so)).rates_launch
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4096
    blocks = sms * 32 * 32 // threads          # 32 warps an SM
    out = torch.empty(blocks * threads, device="cuda")
    for name, (mode, hmma, mufu) in MODES.items():

        def run(n):
            err = fn(mode, ctypes.c_void_p(out.data_ptr()), blocks, threads,
                     n)
            cs.check(err == 0, f"pipe_rates {name}: CUDA error {err}")

        run(16)
        ms = cs.time_ms(lambda: run(iters), 5, 1)
        mhz = cs.sm_clock_mhz()
        # each sub-partition runs 8 of the SM's 32 warps
        cycles = ms * 1e-3 * mhz * 1e6 / (8 * iters)
        print(json.dumps({
            "mode": name, "hmma": hmma, "mufu": mufu, "ms": ms,
            "sm_clock_mhz": mhz, "cycles_per_warp_iteration": cycles,
            "cycles_per_hmma": cycles / hmma if not mufu else None,
            "cycles_per_mufu": cycles / mufu if not hmma else None}),
            flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's ctypes binding of the repo's native CPU rasterizer
(`native/src/rasterizer.cpp`), the counterpart of `tpu_gaussians.native`.

`build()` compiles the shared library, and the `gs_viewer` binary
(`native/src/viewer_main.cpp`, `npz.cpp` and the rasterizer), with g++:

  g++ -O3 -ffast-math -std=c++17 -shared -fPIC -I native/include
      native/src/rasterizer.cpp -o _build/libgs_rasterizer-<hash>.so

into `tpu_gaussians_torch/_build/`, keyed by a hash of the sources, the
headers and the flags as kernels/build.py keys the CUDA builds: an edited
source rebuilds, an unchanged one loads at once. Nothing is written under
`native/`. A failed build raises NativeBuildError with g++'s output.

`render_native(...)` is the forward-only CPU render path, with the input
contract of the reference's pybind module (bindings.cpp:27-101): float32
(N,3)/(N,)/(4,4), checked here. It takes numpy arrays or torch tensors; a
CUDA tensor is copied to the host, since this is a CPU renderer by design.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

PKG = Path(__file__).resolve().parent.parent
NATIVE = PKG.parent / "native"
BUILD = PKG / "_build"
FLAGS = ["-O3", "-ffast-math", "-std=c++17", "-I", str(NATIVE / "include")]
# target -> (sources, extra flags)
TARGETS = {
    "libgs_rasterizer": (["rasterizer.cpp"], ["-shared", "-fPIC"]),
    "gs_viewer": (["viewer_main.cpp", "npz.cpp", "rasterizer.cpp"], []),
}

_LIB: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def _command(target: str, out: Path) -> List[str]:
    sources, extra = TARGETS[target]
    return ["g++", *FLAGS, *extra,
            *(str(NATIVE / "src" / s) for s in sources), "-o", str(out)]


def target_path(target: str) -> Path:
    """Where `target` is built: its name, and a hash of every source and
    header and of the command's flags."""
    h = hashlib.sha256()
    for path in sorted((NATIVE / "include").rglob("*.h")) + [
            NATIVE / "src" / s for s in TARGETS[target][0]]:
        h.update(path.name.encode() + path.read_bytes())
    h.update(" ".join(_command(target, Path("out"))).encode())
    suffix = ".so" if target.startswith("lib") else ""
    return BUILD / f"{target}-{h.hexdigest()[:16]}{suffix}"


def build(force: bool = False) -> Path:
    """Build the library and gs_viewer where not built yet (one g++ each,
    started together); returns the library's path."""
    todo = [t for t in TARGETS if force or not target_path(t).exists()]
    if todo:
        if shutil.which("g++") is None:
            raise NativeBuildError("g++ not found on PATH")
        BUILD.mkdir(parents=True, exist_ok=True)
        procs: Dict[str, tuple] = {}
        for t in todo:
            out = target_path(t)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[t] = (subprocess.Popen(
                _command(t, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for t, (proc, tmp, out) in procs.items():
            text = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{t}: {' '.join(proc.args)}\n{text}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise NativeBuildError("native build failed:\n"
                                   + "\n".join(failed))
    return target_path("libgs_rasterizer")


def viewer_path() -> Path:
    """The built gs_viewer binary (building it if needed)."""
    build()
    return target_path("gs_viewer")


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.gs_render_rgba8.restype = ctypes.c_int
        lib.gs_render_rgba8.argtypes = [fp, fp, fp, fp, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, fp, fp,
                                        fp, ctypes.c_int, u8p]
        lib.gs_render_f32.restype = ctypes.c_int
        lib.gs_render_f32.argtypes = [fp, fp, fp, fp, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, fp, fp, fp,
                                      ctypes.c_int, fp, fp]
        _LIB = lib
    return _LIB


def _host(a) -> np.ndarray:
    """A float32 C-contiguous host array of `a` (a torch tensor on any
    device is copied to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def _as_f32(name: str, a, shape) -> np.ndarray:
    a = _host(a)
    if a.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got {a.shape}")
    return a


def render_native(
    means, scales, colors, opacities, view, proj,
    width: int = 800, height: int = 600,
    background=(0.0, 0.0, 0.0), depth_sort: bool = True,
    as_float: bool = False,
):
    """CPU forward render -> (H,W,4) uint8 RGBA, or (rgb, alpha) float32
    when as_float, as numpy arrays. colors must be pre-evaluated RGB (use
    ops.sh.eval_colors for SH models)."""
    lib = _load()
    means = _host(means)
    if means.ndim != 2 or means.shape[1] != 3:
        raise ValueError("means must be (N,3)")
    n = means.shape[0]
    scales = _as_f32("scales", scales, (n, 3))
    colors = _as_f32("colors", colors, (n, 3))
    opacities = _host(opacities).reshape(-1)
    if opacities.shape != (n,):
        raise ValueError(f"opacities must be ({n},)")
    view = _as_f32("view", view, (4, 4))
    proj = _as_f32("proj", proj, (4, 4))
    bg = _host(background).reshape(3)

    fp = ctypes.POINTER(ctypes.c_float)

    def ptr(a):
        return a.ctypes.data_as(fp)

    mode = 1 if depth_sort else 0
    if as_float:
        rgb = np.empty((height, width, 3), np.float32)
        alpha = np.empty((height, width), np.float32)
        rc = lib.gs_render_f32(
            ptr(means), ptr(scales), ptr(colors), ptr(opacities), n,
            width, height, ptr(view), ptr(proj), ptr(bg), mode,
            ptr(rgb), ptr(alpha))
        if rc != 0:
            raise RuntimeError(f"gs_render_f32 failed with code {rc}")
        return rgb, alpha

    out = np.empty((height, width, 4), np.uint8)
    rc = lib.gs_render_rgba8(
        ptr(means), ptr(scales), ptr(colors), ptr(opacities), n,
        width, height, ptr(view), ptr(proj), ptr(bg), mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc != 0:
        raise RuntimeError(f"gs_render_rgba8 failed with code {rc}")
    return out

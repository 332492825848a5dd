"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain `extern "C"` launcher (no PyTorch headers, so a build takes seconds):

  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
       -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

Libraries are built at first use into `tpu_gaussians_torch/_build/`, keyed
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. `build_all` starts one nvcc per source, all
together. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNELS = ("sorted_fwd",)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}        # nvcc output of builds made in this process


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                       "the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{digest}.so"


def build_all(names: List[str] = KERNELS) -> None:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, started together. Raises with nvcc's output if a
    build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    exe = nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [exe, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)   # atomic: no process loads a half-written file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]

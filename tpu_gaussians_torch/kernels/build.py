"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain `extern "C"` launcher (no PyTorch headers, so a build takes seconds):

  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
       -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

Libraries are built at first use into `tpu_gaussians_torch/_build/`, keyed
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. `build_all` starts one nvcc per source, all
together. Nothing is built or loaded when this module is imported.
`launch` calls a library's launcher on the current CUDA stream; every
kernel wrapper launches through it. `sass_count` counts an opcode in a
built kernel's SASS (cuobjdump), which shows what the compiler made of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNELS = ("sorted_fwd", "sorted_bwd", "splat_sep_fwd", "splat_sep_bwd",
           "splat_v2_fwd", "splat_v2_bwd", "binned_fwd", "binned_bwd",
           "binned_sep_fwd", "binned_sep_bwd", "splat_v1_fwd", "splat_v1_bwd",
           "stage")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}        # nvcc output of builds made in this process
# Raised by utils.debug.interpret_mode (a debugging aid that only an
# explicit caller enters): while it is above 0, every wrapper runs its
# plain twin on CUDA tensors too, and launches nothing.
interpret_depth = 0


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


def on_cuda(name: str, *tensors: torch.Tensor, float4: bool = True) -> bool:
    """True if kernel `name` is to be launched on `tensors` (CUDA, and
    16-byte aligned where the kernel loads float4), False for CPU tensors
    and inside utils.debug.interpret_mode (the plain twin's cases); raises
    on any other device or a misaligned tensor."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {dev}")
    if interpret_depth > 0:
        return False
    if float4 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned (the "
                         "kernel loads float4)")
    return True


def launch(name: str, tensors: Sequence[Optional[torch.Tensor]], *scalars,
           entry: str = "") -> None:
    """Call `<entry>_launch(pointers..., scalars..., stream)` of kernel
    `name`'s library (entry defaults to name) on the current stream of
    tensors[0]'s device: each tensor passes as its device pointer (None as
    a null pointer), a Python float as a C float and any other scalar as a
    C int. Raises on a non-zero CUDA error."""
    fn = getattr(load(name), f"{entry or name}_launch")
    fn.restype = ctypes.c_int
    args = [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in tensors] + [
        ctypes.c_float(s) if isinstance(s, float) else ctypes.c_int(s)
        for s in scalars]
    with torch.cuda.device(tensors[0].device):
        err = fn(*args,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{entry or name}_launch failed with CUDA error "
                           f"{err}")


def build_others(name: str, paths: Sequence[Path]) -> dict:
    """{tag: (library, nvcc output)}: this tree's build of kernel `name`
    under tag "tree", and each other source in `paths` built now under
    `_build/<name>_<stem>.so` (tag: its stem), all nvcc processes started
    together. For the measurement tools that time sources against each
    other; raises with nvcc's output if a build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for path in paths:
        so = BUILD / f"{name}_{path.stem}.so"
        procs[path.stem] = (so, subprocess.Popen(
            [nvcc(), *FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build_all([name])
    out = {"tree": (library_path(name), logs.get(name, ""))}
    for tag, (so, proc) in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{text}")
        out[tag] = (so, text)
    return out


def sass_count(lib: Path, kernel: str, opcode: str) -> int:
    """How many `opcode` instructions the SASS of the function whose name
    contains `kernel` in library `lib` holds, by cuobjdump (the CUDA
    toolkit's, or the copy under Triton's package). Raises if neither is
    found or `lib` holds no single such function."""
    return len(re.findall(rf"\b{opcode}\b", _sass_function(lib, kernel)))


def sass_opcodes(lib: Path, kernel: str) -> Dict[str, int]:
    """{opcode: count} of the SASS of the function whose name contains
    `kernel` in library `lib` (the opcode without its modifiers: HMMA,
    LDS, FADD, ...), most frequent first; raises as sass_count."""
    ops: Dict[str, int] = {}
    line = r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
    for m in re.finditer(line, _sass_function(lib, kernel)):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def _sass_function(lib: Path, kernel: str) -> str:
    tools = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton
        tools.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    tool = next((t for t in tools if t.exists()), None)
    if tool is None:
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise RuntimeError(f"{len(funcs)} functions named {kernel} in {lib}")
    return funcs[0]

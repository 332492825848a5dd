"""The port stands alone: no module of `tpu_gaussians_torch`, and not
`chip_smoke.py`, imports JAX, the JAX package, orbax or optax; each module
of the interop, evaluation and checkpoint slice, and of the parallel
modules and the native binding, imports alone in a fresh interpreter
without them or matplotlib (which cli.view imports only when it runs)."""

import ast
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "tpu_gaussians", "orbax", "optax")
SLICE_MODULES = ("io.ply", "io.colmap", "io.checkpoint", "cli.convert",
                 "cli.make_cameras", "cli.eval", "cli.import_colmap",
                 "cli.view", "utils.debug", "utils.profiling",
                 "parallel.mesh", "parallel.sharded", "parallel.tiled",
                 "native")


def port_files():
    files = sorted((ROOT / "tpu_gaussians_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in port_files()}
    for expected in ("chip_smoke.py", "tpu_gaussians_torch/cli/serve.py",
                     "tpu_gaussians_torch/kernels/sorted_fwd.py",
                     "tpu_gaussians_torch/cli/fit.py",
                     "tpu_gaussians_torch/kernels/splat_sep.py",
                     "tpu_gaussians_torch/kernels/sorted_bwd.py",
                     "tpu_gaussians_torch/kernels/splat_v2.py",
                     "tpu_gaussians_torch/kernels/binned.py",
                     "tpu_gaussians_torch/ops/binned.py"):
        assert expected in names
    for m in SLICE_MODULES:     # a module, or a package's __init__
        path = f"tpu_gaussians_torch/{m.replace('.', '/')}"
        assert f"{path}.py" in names or f"{path}/__init__.py" in names


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def test_importing_the_server_loads_no_jax():
    code = ("import sys; import tpu_gaussians_torch.cli.serve, "
            "tpu_gaussians_torch.cli.render, tpu_gaussians_torch.cli.fit; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def import_alone(module):
    code = (f"import sys; import tpu_gaussians_torch.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('matplotlib',)!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def fresh_imports():
    """Each slice module imported in an interpreter of its own, a few at
    a time (each start-up is mostly torch's import)."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(zip(SLICE_MODULES, pool.map(import_alone,
                                                SLICE_MODULES)))


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_module_imports_alone(fresh_imports, module):
    proc = fresh_imports[module]
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""The port stands alone: no module of `tpu_gaussians_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "tpu_gaussians")


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
                     "tpu_gaussians_torch/kernels/sorted_fwd.py"):
        assert expected in names


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def test_importing_the_server_loads_no_jax():
    code = ("import sys; import tpu_gaussians_torch.cli.serve, "
            "tpu_gaussians_torch.cli.render; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

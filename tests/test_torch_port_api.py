"""Port parity, package-level API: every package of `tpu_gaussians` that the
port mirrors re-exports the same names, in the same `__all__`, from
`tpu_gaussians_torch`, and each name resolves to the port's own object.
Each public function and class of the JAX modules of the interop,
evaluation and checkpoint slice, and of the parallel modules and the
native binding, has a namesake of the same kind in the port's module of
the same path."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("", ".core", ".io", ".models", ".ops", ".fit", ".parallel")
SLICE_MODULES = ("io.ply", "io.colmap", "io.checkpoint", "cli.convert",
                 "cli.make_cameras", "cli.eval", "cli.import_colmap",
                 "cli.view", "utils.debug", "utils.profiling",
                 "parallel.mesh", "parallel.sharded", "parallel.tiled",
                 "native")


def public_callables(module):
    """The public functions and classes defined in a JAX module."""
    mod = importlib.import_module("tpu_gaussians." + module)
    return sorted(n for n, o in vars(mod).items()
                  if not n.startswith("_") and callable(o)
                  and getattr(o, "__module__", None) == mod.__name__)


SLICE_NAMES = [(m, n) for m in SLICE_MODULES for n in public_callables(m)] + [
    ("models.gaussian_model", "init_params_from_points"),
    ("utils.config", "FitConfig.to_json"),
    ("utils.config", "FitConfig.from_json")]


def _pair(sub):
    return (importlib.import_module("tpu_gaussians" + sub),
            importlib.import_module("tpu_gaussians_torch" + sub))


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_all_matches_reference(sub):
    ref, port = _pair(sub)
    assert list(port.__all__) == list(ref.__all__)


@pytest.mark.parametrize("sub,name", [
    (sub, name) for sub in PACKAGES
    for name in importlib.import_module("tpu_gaussians" + sub).__all__],
    ids=lambda v: v or "top")
def test_name_resolves_in_port(sub, name):
    ref, port = _pair(sub)
    obj = getattr(port, name)
    if name == "__version__":
        assert obj == ref.__version__
        return
    # The port's object, of the same kind as the reference's, under its
    # own module.
    assert type(obj).__name__ == type(getattr(ref, name)).__name__
    home = obj.__name__ if type(obj).__name__ == "module" else obj.__module__
    assert home.startswith("tpu_gaussians_torch.")


def test_documented_imports():
    import tpu_gaussians_torch as t
    from tpu_gaussians_torch.fit import (  # noqa: F401
        DensifyConfig, LossConfig, densify_and_prune, loss_fn,
        make_train_step)
    from tpu_gaussians_torch.ops.dispatch import render

    assert t.render is render
    assert t.camera.orbit_cameras is not None
    assert t.RenderConfig().mode == "accum"


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_package_import_alone_loads_no_jax(sub):
    """Each package imports in a fresh interpreter, first of all the port's
    modules (no import cycle), without pulling in JAX."""
    code = (f"import sys; import tpu_gaussians_torch{sub} as m; "
            "[getattr(m, k) for k in m.__all__]; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_gaussians')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module,name", SLICE_NAMES,
                         ids=[f"{m}.{n}" for m, n in SLICE_NAMES])
def test_slice_name_has_port_namesake(module, name):
    ref = importlib.import_module("tpu_gaussians." + module)
    port = importlib.import_module("tpu_gaussians_torch." + module)
    for part in name.split("."):
        ref, port = getattr(ref, part), getattr(port, part)
    assert isinstance(port, type) == isinstance(ref, type)
    assert port.__module__ == "tpu_gaussians_torch." + module

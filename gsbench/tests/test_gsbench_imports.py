"""What the harness and the reference load: never JAX or the JAX
package, and the reference nothing of the program. Top-level module names
are compared whole: tpu_gaussians_torch is the port."""

import json
import subprocess
import sys

from gsbench.tests.tiny import REPO


def loaded(code: str):
    script = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n{code}\n"
              "import json\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, cwd=str(REPO))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    mods = loaded("import gsbench.reference.render, gsbench.reference.train,"
                  " gsbench.counts, gsbench.scene")
    assert not mods & {"jax", "jaxlib", "flax", "tpu_gaussians",
                       "tpu_gaussians_torch"}


def test_harness_loads_no_jax():
    mods = loaded("from gsbench import harness\n"
                  "harness.traffic_kind(harness.Path({!r}), 'fit')\n"
                  "harness.traffic_kind(harness.Path({!r}), 'serve')\n"
                  "import tpu_gaussians_torch.cli.serve, "
                  "tpu_gaussians_torch.fit.trainer".format(str(REPO),
                                                           str(REPO)))
    assert "tpu_gaussians_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "tpu_gaussians"}


def test_forbidden_compares_whole_names(monkeypatch):
    from gsbench import harness

    monkeypatch.setitem(sys.modules, "tpu_gaussians_torch_x", sys)
    assert "tpu_gaussians" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_loaded()

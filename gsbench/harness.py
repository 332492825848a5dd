"""Finding a cell's files by name, and what every run reports.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name BENCHMARK.json gives it:
  BENCHMARK.json                    the cells, configurations and metrics
  gsbench/configs/<config>.json     a configuration (the `file` entry)
  gsbench/traffic/<traffic>.json    a traffic mix; its "kind" names the
                                    driver gsbench/traffic/<kind>.py
  gsbench/workloads/<cell>.json     the cell's correctness limits
  gsbench/metrics/<metric>.py       a per-layer metric's reader
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

# Top-level module names the process may not hold once the window has
# closed: the JAX package and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_gaussians")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root: Path, name: str) -> dict:
    """The cell `name` of root/BENCHMARK.json with its configuration,
    traffic mix, limits and metrics resolved from their files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[work["config"]]["file"])
    traffic = load_json(root / "gsbench" / "traffic" / f"{work['traffic']}.json")
    limits = load_json(root / "gsbench" / "workloads" / f"{name}.json")

    def applies(m: dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return {"name": name, "chips": work["chips"], "config": config,
            "traffic": traffic, "limits": limits["limits"],
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)],
            "root": root}


def traffic_kind(root: Path, kind: str) -> ModuleType:
    return load_module(root / "gsbench" / "traffic" / f"{kind}.py",
                       f"gsbench_traffic_{kind}")


def read_metrics(root: Path, metrics: List[dict], facts: dict
                 ) -> Dict[str, dict]:
    """Each per-layer metric by its own reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(root / "gsbench" / "metrics" / f"{m['name']}.py",
                             "gsbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(facts)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def checks_text(checks: List[tuple]) -> List[str]:
    return [f"check {name}: {value!r} (limit {limit!r})"
            for name, value, limit in checks]

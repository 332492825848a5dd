"""A benchmark tree of tiny cells in a temporary directory: BENCHMARK.json
and gsbench/ copied, every configuration and mix shrunk to CPU sizes."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FIT = "fit_100k_ewa_sorted_1080p"
SERVE = "serve_1m_quality_1080p"

# 4096 gaussians: the least capacity at which EWA training takes the
# sorted route.
SHRINK_CONFIG = {"num_gaussians": 4096, "capacity": 4096}
SHRINK_TRAFFIC = {
    "fit": {"width": 200, "height": 40, "view_pool": 12, "warm_steps": 1,
            "trace_steps": 2, "trace_steps_stack": 1, "trace_pad_s": 0.0},
    "serve": {"clients": 2, "width": 150, "height": 40, "warm_frames": 1,
              "check_frames": 3, "trace_frames_per_client": 1,
              "trace_frames_seq": 1, "trace_pad_s": 0.0,
              "max_frames_per_client": 50, "keep_every": 1,
              "tail_seconds": 0.5},
}


def tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark with every cell at a tiny size."""
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / "gsbench", root / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (root / "gsbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(SHRINK_CONFIG)
        path.write_text(json.dumps(cfg))
    for path in (root / "gsbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(SHRINK_TRAFFIC[mix["kind"]])
        path.write_text(json.dumps(mix))
    return root

"""The fit config tree: every reference CLI flag, name and default preserved
verbatim (fit_multiview_stub.py:201-229), plus the extensions of
`tpu_gaussians.utils.config` (impl, capacity behaviour, sharding,
checkpointing) with the same names and defaults. `impl` takes this
package's values: auto | torch | tiled."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass
class FitConfig:
    # Data / paths (fit_multiview_stub.py:202-206)
    targets_dir: str = ""
    out_dir: str = "outputs/fit_multiview"
    camera_npz: str = ""
    masks_dir: str = ""
    depth_dir: str = ""

    # Optimization (:208-213)
    iters: int = 300
    lr: float = 0.02
    width: int = 128
    height: int = 128
    num_gaussians: int = 800
    max_gaussians: int = 3000

    # Appearance (:215)
    use_sh: bool = False
    sh_degree: int = 1  # 1 = reference SH convention; 2/3 = 3DGS real SH

    # Densify / prune (:217-220)
    densify_interval: int = 80
    prune_interval: int = 80
    densify_ratio: float = 0.15
    prune_opacity: float = 0.05

    # Loss stack (:222-227)
    silhouette_weight: float = 0.2
    mask_thresh: float = 0.06
    depth_weight: float = 0.05
    reg_opacity: float = 0.001
    reg_scale: float = 0.001
    ssim_weight: float = 0.0  # 3DGS-style D-SSIM term (extension; 0 = ref)

    # --- extensions (no reference counterpart) ---
    seed: int = 0
    impl: str = "auto"            # renderer impl: auto | torch | tiled
    footprint: str = "axis"       # axis (reference parity) | ewa (quat+cov)
    render_mode: str = "auto"     # auto (footprint-aware, see
                                  # resolve_render_mode) | accum
                                  # (reference training semantics) |
                                  # sorted (depth-sorted alpha blending)
    accum_binned: str = "auto"    # accum kernel choice: auto | on | off
    clone_metric: str = "opacity"  # densify ranking: opacity (reference) | grad
    split_scale_thresh: float = 0.0  # 3DGS split: cloned gaussians whose max
                                     # world scale exceeds this are SPLIT
                                     # (parent+child shrunk by split_shrink,
                                     # child keeps opacity); 0 = off (ref)
    split_shrink: float = 1.6        # 3DGS split scale divisor
    opacity_reset_interval: int = 0  # 3DGS: clamp opacities to <= reset value
                                     # every N iters; 0 = off (reference)
    opacity_reset_value: float = 0.01
    init_npz: str = ""               # warm-start from an exported npz;
                                     # overrides random init
    means_lr_final: float = 1.0      # final means-lr multiplier, decayed
                                     # exponentially over iters (3DGS uses
                                     # ~0.01); 1.0 = constant lr (reference)
    log_every: int = 25            # print cadence (reference prints every 25, :315)
    checkpoint_every: int = 0      # 0 = only final artifacts (reference behavior)
    resume: bool = False           # resume from latest checkpoint in out_dir
    num_view_shards: int = 1       # views axis sharding over devices
    sorted_pair_k: int = 0         # sorted-mode per-gaussian tile budget;
                                   # 0 = measured at init
    metrics_jsonl: bool = True     # structured per-step metrics to metrics.jsonl

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "FitConfig":
        return FitConfig(**json.loads(text))


# EWA models at or above this capacity train in sorted mode under
# render_mode="auto": the mode that matches the sorted compositing a
# viewer deploys (`tpu_gaussians.utils.config`).
SORTED_EWA_MIN_CAPACITY = 4_096


def resolve_render_mode(config: FitConfig, capacity: int) -> str:
    """render_mode="auto" -> a concrete training mode: the axis footprint
    trains "accum" (reference semantics); the EWA footprint trains
    "sorted" at capacity >= SORTED_EWA_MIN_CAPACITY, else "accum"."""
    if config.render_mode != "auto":
        return config.render_mode
    if config.footprint == "ewa" and capacity >= SORTED_EWA_MIN_CAPACITY:
        return "sorted"
    return "accum"

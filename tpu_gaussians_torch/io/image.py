"""Image/target loading and saving (PIL + numpy), matching the reference
loaders as `tpu_gaussians.io.image` does.

Targets: sorted png/jpg/jpeg glob, bilinear resize, /255
(fit_multiview_stub.py:16-34). Masks/depth: stem-matched grayscale PNGs
(:45-67); mask auto-estimation mean(rgb) > thresh (:37-42).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np


def _pil():
    from PIL import Image
    return Image


def load_image_rgb(path: Union[str, Path], width: int, height: int) -> np.ndarray:
    Image = _pil()
    img = Image.open(path).convert("RGB").resize(
        (width, height), Image.Resampling.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def load_image_gray(path: Union[str, Path], width: int, height: int) -> np.ndarray:
    Image = _pil()
    img = Image.open(path).convert("L").resize(
        (width, height), Image.Resampling.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def list_target_paths(targets_dir: Union[str, Path]) -> List[Path]:
    targets_dir = Path(targets_dir)
    paths = sorted([*targets_dir.glob("*.png"), *targets_dir.glob("*.jpg"),
                    *targets_dir.glob("*.jpeg")])
    if not paths:
        raise FileNotFoundError(
            f"No target images found in {targets_dir} (supported: png/jpg/jpeg)")
    return paths


def load_targets(paths: List[Path], width: int, height: int) -> np.ndarray:
    """-> (V, H, W, 3) float32 in [0,1]."""
    return np.stack([load_image_rgb(p, width, height) for p in paths], axis=0)


def estimate_masks(targets: np.ndarray, thresh: float) -> np.ndarray:
    """Auto silhouette masks: mean(rgb) > thresh (fit_multiview_stub.py:37-42)."""
    return (targets.mean(axis=3) > thresh).astype(np.float32)


def load_optional_stem_matched(
    paths: List[Path], directory: Optional[Union[str, Path]],
    width: int, height: int,
) -> Optional[np.ndarray]:
    """Load {stem}.png grayscale maps for each target; None when the dir is
    unset or any map is missing (fit_multiview_stub.py:45-67 semantics)."""
    if directory is None:
        return None
    directory = Path(directory)
    out = []
    for p in paths:
        candidate = directory / f"{p.stem}.png"
        if not candidate.exists():
            return None
        out.append(load_image_gray(candidate, width, height))
    return np.stack(out, axis=0)


def save_image_png(path: Union[str, Path], image: np.ndarray) -> None:
    """Save (H,W,3) float [0,1] as RGB PNG (fit_multiview_stub.py:379-380)."""
    u8 = (np.clip(np.asarray(image), 0.0, 1.0) * 255.0).astype(np.uint8)
    _pil().fromarray(u8, mode="RGB").save(Path(path))

"""Image saving for the render CLI (PIL)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np


def save_image_png(path: Union[str, Path], image: np.ndarray) -> None:
    """Save (H,W,3) float [0,1] as RGB PNG (fit_multiview_stub.py:379-380)."""
    from PIL import Image

    u8 = (np.clip(np.asarray(image), 0.0, 1.0) * 255.0).astype(np.uint8)
    Image.fromarray(u8, mode="RGB").save(Path(path))

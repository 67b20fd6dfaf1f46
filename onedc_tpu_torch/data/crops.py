"""Multi-resolution crops of numpy images, host side.

JAX counterpart, copied: ``onedc_tpu/data/datasets.py:56-112`` (``resize``,
``resize_if_small``, ``random_crop``, ``MultiResolutionCrop``). Images are
(H, W, 3) float arrays in [-1, 1]. PIL is needed only to upscale an image
smaller than the crop, and is imported then.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def resize(arr: np.ndarray, size_hw) -> np.ndarray:
    from PIL import Image

    h, w = size_hw
    img = Image.fromarray(
        np.clip((arr + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8))
    img = img.resize((w, h), Image.BILINEAR)
    return np.asarray(img).astype(np.float32) / 127.5 - 1.0


def resize_if_small(arr: np.ndarray, min_size: int) -> np.ndarray:
    """Upscale so min(H, W) >= min_size, keeping the aspect ratio."""
    h, w = arr.shape[:2]
    if min(h, w) >= min_size:
        return arr
    scale = min_size / min(h, w)
    return resize(arr, (max(min_size, int(round(h * scale))),
                        max(min_size, int(round(w * scale)))))


def random_crop(arr: np.ndarray, size: int, rng: np.random.Generator):
    h, w = arr.shape[:2]
    if h < size or w < size:
        arr = resize_if_small(arr, size)
        h, w = arr.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return arr[top:top + size, left:left + size]


class MultiResolutionCrop:
    """Per-step (resolution, batch scale) choice from a config list,
    deterministic in the step index."""

    def __init__(self, resolutions: Sequence[int],
                 batch_scales: Optional[Sequence[float]] = None):
        self.resolutions = list(resolutions)
        self.batch_scales = list(batch_scales or [1.0] * len(resolutions))
        if len(self.batch_scales) != len(self.resolutions):
            raise ValueError("one batch scale per resolution")

    def pick(self, step: int):
        rng = np.random.default_rng((step << 16) ^ 0x9E3779B9)
        idx = int(rng.integers(0, len(self.resolutions)))
        return self.resolutions[idx], self.batch_scales[idx]

"""Host-side augmentation (numpy), as ``bayer_low_light_image_enhancement_tpu/
data/augment.py``: an even-aligned random crop to ``patch_size`` (offsets are
even so the crop stays on the Bayer grid), then a horizontal flip with
p 0.5 and a vertical flip with p 0.2, of the mosaic before packing (which
shifts the CFA phase; the reference accepts that as augmentation noise)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_even_crop(
    rng: np.random.Generator, raw: np.ndarray, gt: np.ndarray, patch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """raw: [H, W] mosaic; gt: [H, W, 3] at the same resolution."""
    h, w = raw.shape[:2]
    i = int(rng.integers(0, (h - patch_size - 2) // 2 + 1)) * 2
    j = int(rng.integers(0, (w - patch_size - 2) // 2 + 1)) * 2
    return raw[i : i + patch_size, j : j + patch_size], gt[i : i + patch_size, j : j + patch_size]


def random_flips(
    rng: np.random.Generator, raw: np.ndarray, gt: np.ndarray, p_lr: float = 0.5,
    p_ud: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    if rng.random() < p_lr:
        raw, gt = raw[:, ::-1], gt[:, ::-1]
    if rng.random() < p_ud:
        raw, gt = raw[::-1], gt[::-1]
    return np.ascontiguousarray(raw), np.ascontiguousarray(gt)

"""Synthetic SID-like Bayer data for tests, smoke runs and benchmarks.

As ``bayer_low_light_image_enhancement_tpu/data/synthetic.py`` (numpy, the
same samples for the same seed): a smooth random RGB scene, mosaicked
through an RGGB CFA, darkened by the exposure ratio, with Gaussian read
noise, quantised to the SID uint14 code range. ``write_sid_tree`` writes
such pairs to disk in the SID layout, for the SID loaders and the CLIs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bayer_low_light_image_enhancement_tpu_torch.data import augment
from bayer_low_light_image_enhancement_tpu_torch.data.sid import BLACK_LEVEL, WHITE_LEVEL


def synth_scene(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random RGB scene in [0, 1]: a few low-frequency sinusoids."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(4):
        fy, fx = rng.uniform(0.5, 4.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.1, 0.4, 3)
        base = np.sin(2 * np.pi * (fy * yy / h + fx * xx / w))
        img += amp * np.sin(ph)[None, None, :] + amp[None, None, :] * base[..., None]
    img = (img - img.min()) / (img.max() - img.min() + 1e-6)
    return img.astype(np.float32)


def mosaic_rggb(rgb: np.ndarray) -> np.ndarray:
    h, w, _ = rgb.shape
    m = np.empty((h, w), np.float32)
    m[0::2, 0::2] = rgb[0::2, 0::2, 0]
    m[0::2, 1::2] = rgb[0::2, 1::2, 1]
    m[1::2, 0::2] = rgb[1::2, 0::2, 1]
    m[1::2, 1::2] = rgb[1::2, 1::2, 2]
    return m


class SyntheticBayerDataset:
    """``sample(idx, rng) -> (mosaic01 [h,w,1] fp32, gt [h,w,3], ratio)``, or
    with ``device_normalize`` the raw uint16 codes in place of mosaic01."""

    def __init__(
        self,
        num_images: int = 8,
        full_size: Tuple[int, int] = (128, 192),
        patch_size: int = 64,
        training: bool = True,
        ratio: float = 100.0,
        seed: int = 0,
        device_normalize: bool = False,
    ):
        self.patch_size = patch_size
        self.training = training
        self.ratio = ratio
        self.device_normalize = device_normalize
        rng = np.random.default_rng(seed)
        h, w = full_size
        self.gts = [synth_scene(rng, h, w) for _ in range(num_images)]
        self.mosaics = []
        for gt in self.gts:
            dark = mosaic_rggb(gt) / ratio
            noise = rng.normal(0, 0.5 / WHITE_LEVEL, dark.shape).astype(np.float32)
            code = dark * (WHITE_LEVEL - BLACK_LEVEL) + BLACK_LEVEL
            code = np.clip(code + noise * WHITE_LEVEL, 0, WHITE_LEVEL)
            self.mosaics.append(code.astype(np.uint16))

    def __len__(self) -> int:
        return len(self.gts)

    def sample(self, idx: int, rng: np.random.Generator):
        mosaic, gt = self.mosaics[idx], self.gts[idx]
        if self.training:
            mosaic, gt = augment.random_even_crop(rng, mosaic, gt, self.patch_size)
            mosaic, gt = augment.random_flips(rng, mosaic, gt)
        if self.device_normalize:
            return mosaic[..., None].astype(np.uint16), gt, np.float32(self.ratio)
        m = np.clip(mosaic.astype(np.float32), BLACK_LEVEL, WHITE_LEVEL)
        m = (m - BLACK_LEVEL) / (WHITE_LEVEL - BLACK_LEVEL + 1e-6) * self.ratio
        return m[..., None], gt, np.float32(self.ratio)


def write_sid_tree(root: str, cache_dir: str, shapes: Dict[str, Sequence[Tuple[int, int]]],
                   rng: np.random.Generator) -> Dict[str, Tuple[List[str], List[str]]]:
    """Write synthetic pairs in the SID layout: empty placeholder ARWs
    ``<root>/Sony/short/<id>_00_0.1s.ARW`` and ``<root>/Sony/long/<id>_00_
    {10,30}s.ARW`` (ratio 100 / 300, alternating), with their decodes in the
    npz cache (``data.raw``: ``mosaic`` uint16 [H, W] codes in [512, 16383],
    ``rgb`` uint16 [H, W, 3]). ``shapes`` maps "train" (ids 0xxxx) and
    "test" (ids 1xxxx) to the frames' (H, W). Returns (shorts, longs) per
    split, in ``discover_sid_pairs``' order."""
    for d in ("Sony/short", "Sony/long"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    os.makedirs(cache_dir, exist_ok=True)
    out = {}
    for split, frames in shapes.items():
        shorts, longs = [], []
        for k, (h, w) in enumerate(frames):
            sid = f"{0 if split == 'train' else 1}{k:04d}"
            exposure, ratio = ("10s", 100.0) if k % 2 == 0 else ("30s", 300.0)
            short = os.path.join(root, "Sony/short", f"{sid}_00_0.1s.ARW")
            long = os.path.join(root, "Sony/long", f"{sid}_00_{exposure}.ARW")
            gt = synth_scene(rng, h, w)
            dark = mosaic_rggb(gt) / ratio
            code = dark * (WHITE_LEVEL - BLACK_LEVEL) + BLACK_LEVEL
            code += rng.normal(0, 0.5, dark.shape).astype(np.float32)
            mosaic = np.clip(np.round(code), BLACK_LEVEL, WHITE_LEVEL).astype(np.uint16)
            for path in (short, long):
                open(path, "wb").close()
            np.savez(os.path.join(cache_dir, os.path.basename(short) + ".npz"), mosaic=mosaic)
            np.savez(os.path.join(cache_dir, os.path.basename(long) + ".npz"),
                     rgb=np.round(gt * 65535.0).astype(np.uint16))
            shorts.append(short)
            longs.append(long)
        out[split] = (shorts, longs)
    return out

"""SID (See-in-the-Dark, Sony) dataset.

Port of ``bayer_low_light_image_enhancement_tpu/data/sid.py`` (numpy, the
same samples for the same seed). Pairs a short-exposure Bayer mosaic (ARW)
with a long-exposure RGB ground truth, as the reference does:

* pair discovery: shorts glob ``Sony/short/{0,2}*_00_0.1s.ARW`` (train) /
  ``1*_00_0.1s.ARW`` (test), each matched to ``Sony/long/*<id>*.ARW`` by
  its scene id ``path[-17:-12]``;
* split lists ``Sony_{train,val,test}_list.txt`` with rows
  ``short_path long_path ISO F-stop``;
* amplification ratio 300 if the GT exposure digit ``long_path[-7]`` is
  '3', else 100;
* normalisation: clip to [512, 16383], subtract the black level, scale by
  the ratio. With ``device_normalize`` the host only crops and flips the
  uint16 mosaic and the card decodes it (``ops.bayer.normalize_sid``, or
  kernel K1 in ``Predictor.raw_u16``).

Samples are NHWC: (mosaic [ps, ps, 1] fp32 amplified, or uint16 with
``device_normalize``; gt [ps, ps, 3] fp32 in [0, 1]; ratio).
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bayer_low_light_image_enhancement_tpu_torch.data import augment
from bayer_low_light_image_enhancement_tpu_torch.data import raw as raw_decode

# SID Sony A7S2 black and white levels (14-bit codes).
BLACK_LEVEL = 512.0
WHITE_LEVEL = 16383.0


def sid_ratio_from_filename(long_path: str) -> float:
    return 300.0 if long_path[-7] == "3" else 100.0


def discover_sid_pairs(root: str, split: str = "train") -> Tuple[List[str], List[str]]:
    """(shorts, longs) of ``split`` ("train": ids 0* and 2*; else 1*)."""
    if split == "train":
        shorts = sorted(
            glob.glob(os.path.join(root, "Sony/short/0*_00_0.1s.ARW"))
            + glob.glob(os.path.join(root, "Sony/short/2*_00_0.1s.ARW"))
        )
    else:
        shorts = sorted(glob.glob(os.path.join(root, "Sony/short/1*_00_0.1s.ARW")))
    longs = []
    for x in shorts:
        longs += glob.glob(os.path.join(root, "Sony/long/", "*" + x[-17:-12] + "*.ARW"))
    return shorts, longs


def parse_sid_list(list_path: str, root: str = "") -> Tuple[List[str], List[str]]:
    """Parse a Sony_*_list.txt split file: ``short long ISO F`` rows."""
    shorts, longs = [], []
    with open(list_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            s, l = parts[0], parts[1]
            s = s[2:] if s.startswith("./") else s
            l = l[2:] if l.startswith("./") else l
            shorts.append(os.path.join(root, s))
            longs.append(os.path.join(root, l))
    return shorts, longs


class SIDDataset:
    """In-RAM (``preload``) or cache-backed SID dataset with the reference's
    augmentation: an even crop, then the flips."""

    def __init__(
        self,
        short_paths: Sequence[str],
        long_paths: Sequence[str],
        patch_size: int = 512,
        training: bool = True,
        cache_dir: Optional[str] = None,
        preload: bool = True,
        device_normalize: bool = False,
    ):
        assert len(short_paths) == len(long_paths)
        self.short_paths = list(short_paths)
        self.long_paths = list(long_paths)
        self.patch_size = patch_size
        self.training = training
        self.cache_dir = cache_dir
        self.device_normalize = device_normalize
        self._shorts: Optional[List[np.ndarray]] = None
        self._longs: Optional[List[np.ndarray]] = None
        if preload:
            self._shorts = [raw_decode.load_short(p, cache_dir) for p in short_paths]
            self._longs = [raw_decode.load_long(p, cache_dir) for p in long_paths]

    def __len__(self) -> int:
        return len(self.short_paths)

    def _get_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._shorts is not None:
            return self._shorts[idx], self._longs[idx]
        return (
            raw_decode.load_short(self.short_paths[idx], self.cache_dir),
            raw_decode.load_long(self.long_paths[idx], self.cache_dir),
        )

    def sample(self, idx: int, rng: np.random.Generator):
        mosaic, gt16 = self._get_raw(idx)
        ratio = sid_ratio_from_filename(self.long_paths[idx])
        if self.training:
            mosaic, gt16 = augment.random_even_crop(rng, mosaic, gt16, self.patch_size)
            mosaic, gt16 = augment.random_flips(rng, mosaic, gt16)
        gt = np.clip(gt16, 0, 65535).astype(np.float32) / 65535.0
        if self.device_normalize:
            return mosaic[..., None].astype(np.uint16), gt, np.float32(ratio)
        m = np.clip(mosaic.astype(np.float32), BLACK_LEVEL, WHITE_LEVEL)
        m = (m - BLACK_LEVEL) / (WHITE_LEVEL - BLACK_LEVEL + 1e-6) * ratio
        return m[..., None], gt, np.float32(ratio)

"""MCR (Mono-Colored RAW paired) dataset.

Port of ``bayer_low_light_image_enhancement_tpu/data/mcr.py`` (numpy, the
same samples for the same seed): PNG-encoded colour-RAW inputs paired with
RGB ground truth, as the reference's ``load_dataset.py`` reads them:

* amplification ``gt_expo / img_expo``: ``img_expo`` is the hex exposure
  field ``int(path[-8:-4], 16)``, ``gt_expo`` 12287 for image numbers
  ``int(path[-23:-20])`` below 500, else 1023;
* input ``raw / 255 * amp``, GT ``rgb / 255``; with ``device_normalize``
  the uint8 codes are handed over and the card decodes them
  (``ops.bayer.normalize_mcr``);
* the same even crop and flips as SID.

``imageio`` is imported only when a PNG is read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from bayer_low_light_image_enhancement_tpu_torch.data import augment


def _read_png(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path))


def mcr_amplification(path: str) -> float:
    img_num = int(path[-23:-20])
    img_expo = int(path[-8:-4], 16)
    gt_expo = 12287 if img_num < 500 else 1023
    return gt_expo / img_expo


class MCRDataset:
    def __init__(
        self,
        raw_paths: Sequence[str],
        rgb_paths: Sequence[str],
        patch_size: int = 512,
        training: bool = True,
        preload: bool = True,
        device_normalize: bool = False,
    ):
        assert len(raw_paths) == len(rgb_paths)
        self.raw_paths = list(raw_paths)
        self.rgb_paths = list(rgb_paths)
        self.patch_size = patch_size
        self.training = training
        self.device_normalize = device_normalize
        self._raws: Optional[List[np.ndarray]] = None
        self._rgbs: Optional[List[np.ndarray]] = None
        if preload:
            self._raws = [_read_png(p) for p in raw_paths]
            self._rgbs = [_read_png(p) for p in rgb_paths]

    def __len__(self) -> int:
        return len(self.raw_paths)

    def _get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._raws is not None:
            return self._raws[idx], self._rgbs[idx]
        return _read_png(self.raw_paths[idx]), _read_png(self.rgb_paths[idx])

    def sample(self, idx: int, rng: np.random.Generator):
        raw, rgb = self._get(idx)
        amp = mcr_amplification(self.raw_paths[idx])
        gt = rgb.astype(np.float32) / 255.0
        if self.device_normalize:
            inp8 = raw
            if self.training:
                inp8, gt = augment.random_even_crop(rng, inp8, gt, self.patch_size)
                inp8, gt = augment.random_flips(rng, inp8, gt)
            return inp8[..., None].astype(np.uint8), gt, np.float32(amp)
        inp = (raw.astype(np.float32) / 255.0 * amp).astype(np.float32)
        if self.training:
            inp, gt = augment.random_even_crop(rng, inp, gt, self.patch_size)
            inp, gt = augment.random_flips(rng, inp, gt)
        return inp[..., None], gt, np.float32(amp)

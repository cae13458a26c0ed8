"""Host-side RAW (ARW) decode gateway.

Port of ``bayer_low_light_image_enhancement_tpu/data/raw.py``. Decoding
stays on the host (LibRaw through ``rawpy``); access goes through this
module so that:

* environments with ``rawpy`` decode ARW containers directly
  (``raw_image_visible`` for short exposures, LibRaw's full ``postprocess``
  for the ground truth, as the reference's ``load_dataset.py`` does);
* environments without it read a **decoded cache**: one ``.npz`` file per
  ARW, ``<cache_dir>/<basename of the ARW>.npz``, holding ``mosaic``
  (uint16 [H, W], short exposures) or ``rgb`` (uint16 [H, W, 3], long
  exposures), written once by ``cache_decode`` on a machine with rawpy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:  # rawpy is optional: the npz cache serves where it is missing
    import rawpy  # type: ignore

    HAVE_RAWPY = True
except ImportError:
    rawpy = None
    HAVE_RAWPY = False


def decode_short_arw(path: str) -> np.ndarray:
    """Short-exposure ARW -> uint16 Bayer mosaic [H, W]."""
    if not HAVE_RAWPY:
        raise RuntimeError(
            "rawpy is not available; decode ARW files once with cache_decode() "
            "on a machine with rawpy, then point the dataset at the cache dir"
        )
    with rawpy.imread(path) as raw:
        return raw.raw_image_visible.copy()


def decode_long_arw(path: str) -> np.ndarray:
    """Long-exposure ARW -> uint16 RGB [H, W, 3] via LibRaw's full ISP
    (camera white balance, no auto-bright, 16 bits)."""
    if not HAVE_RAWPY:
        raise RuntimeError("rawpy is not available (see decode_short_arw)")
    with rawpy.imread(path) as raw:
        return raw.postprocess(
            use_camera_wb=True, half_size=False, no_auto_bright=True, output_bps=16
        ).copy()


def cache_path(cache_dir: str, path: str) -> str:
    """The npz cache file of the ARW at ``path``."""
    return os.path.join(cache_dir, os.path.basename(path) + ".npz")


def cache_decode(short_path: str, long_path: str, cache_dir: str) -> None:
    """Decode one (short, long) ARW pair into the npz cache."""
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(cache_path(cache_dir, short_path), mosaic=decode_short_arw(short_path))
    np.savez_compressed(cache_path(cache_dir, long_path), rgb=decode_long_arw(long_path))


def load_short(path: str, cache_dir: Optional[str] = None) -> np.ndarray:
    if cache_dir is not None:
        cp = cache_path(cache_dir, path)
        if os.path.exists(cp):
            with np.load(cp) as z:
                return z["mosaic"]
    return decode_short_arw(path)


def load_long(path: str, cache_dir: Optional[str] = None) -> np.ndarray:
    if cache_dir is not None:
        cp = cache_path(cache_dir, path)
        if os.path.exists(cp):
            with np.load(cp) as z:
                return z["rgb"]
    return decode_long_arw(path)

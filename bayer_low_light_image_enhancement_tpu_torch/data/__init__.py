"""Data: the synthetic SID-like dataset, augmentation and the batch
pipeline. The SID / MCR / raw-file loaders and the C++ batch engine of the
JAX package are not ported yet."""

from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import Loader, prefetch_to_device
from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import (
    BLACK_LEVEL,
    WHITE_LEVEL,
    SyntheticBayerDataset,
    mosaic_rggb,
    synth_scene,
)

__all__ = [
    "BLACK_LEVEL",
    "WHITE_LEVEL",
    "Loader",
    "SyntheticBayerDataset",
    "mosaic_rggb",
    "prefetch_to_device",
    "synth_scene",
]

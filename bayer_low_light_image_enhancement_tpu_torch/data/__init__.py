"""Data: the SID / MCR loaders (ARW through an npz cache, MCR PNGs), the
synthetic SID-like dataset, augmentation, the Python batch pipeline and the
native C++ batch engine (``data.native``, built on first use)."""

from bayer_low_light_image_enhancement_tpu_torch.data.sid import (
    BLACK_LEVEL,
    WHITE_LEVEL,
    SIDDataset,
    discover_sid_pairs,
    parse_sid_list,
    sid_ratio_from_filename,
)
from bayer_low_light_image_enhancement_tpu_torch.data.mcr import MCRDataset, mcr_amplification
from bayer_low_light_image_enhancement_tpu_torch.data.pipeline import Loader, prefetch_to_device
from bayer_low_light_image_enhancement_tpu_torch.data.synthetic import (
    SyntheticBayerDataset,
    mosaic_rggb,
    synth_scene,
)

__all__ = [
    "BLACK_LEVEL",
    "WHITE_LEVEL",
    "Loader",
    "MCRDataset",
    "SIDDataset",
    "SyntheticBayerDataset",
    "discover_sid_pairs",
    "mcr_amplification",
    "mosaic_rggb",
    "parse_sid_list",
    "prefetch_to_device",
    "sid_ratio_from_filename",
    "synth_scene",
]

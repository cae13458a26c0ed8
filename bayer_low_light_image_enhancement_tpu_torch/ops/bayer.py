"""Bayer mosaic handling: CFA-aware packing and SID/MCR normalisation.

Port of ``bayer_low_light_image_enhancement_tpu/ops/bayer.py``. The fused
CUDA version of ``normalize_sid`` + ``pack_bayer`` for RGGB lives in
``kernels/bayer_pack.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from bayer_low_light_image_enhancement_tpu_torch.ops.shuffle import space_to_depth

# For each CFA pattern: position (i, j) within the 2x2 tile of (R, G1, G2, B),
# where G1 is the green sharing a row with R. space_to_depth on [B,H,W,1]
# yields plane order [(0,0), (0,1), (1,0), (1,1)].
CFA_PATTERNS: Dict[str, Tuple[int, int, int, int]] = {
    # plane index (into s2d output) of    R  G1  G2  B
    "RGGB": (0, 1, 2, 3),
    "BGGR": (3, 2, 1, 0),
    "GRBG": (1, 0, 3, 2),
    "GBRG": (2, 3, 0, 1),
}


def pack_bayer(x: torch.Tensor, pattern: str = "RGGB") -> torch.Tensor:
    """[B, H, W, 1] mosaic -> [B, H/2, W/2, 4] planes in (R, G1, G2, B) order."""
    planes = space_to_depth(x, 2)
    idx = list(CFA_PATTERNS[pattern.upper()])
    return planes[..., idx]


def normalize_sid(
    mosaic: torch.Tensor,
    ratio: Union[torch.Tensor, float],
    black_level: float = 512.0,
    white_level: float = 16383.0,
) -> torch.Tensor:
    """uint16 mosaic -> amplified float in [0, ratio].

    ``ratio`` broadcasts per image: a scalar or shape [B, 1, 1, 1].
    """
    x = mosaic.to(torch.float32).clamp(black_level, white_level)
    x = (x - black_level) / (white_level - black_level + 1e-6)
    return x * ratio


def normalize_mcr(raw: torch.Tensor, amp: Union[torch.Tensor, float]) -> torch.Tensor:
    """uint8 PNG-encoded RAW -> amplified float (``raw / 255 * amp``)."""
    return raw.to(torch.float32) / 255.0 * amp

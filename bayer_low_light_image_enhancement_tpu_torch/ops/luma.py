"""Bayer-domain luma / chroma extraction.

Port of ``bayer_low_light_image_enhancement_tpu/ops/luma.py``: luma from
the packed (R, G1, G2, B) NHWC planes with G = avg(G1, G2), optionally
normalised by the per-image max, chroma cr = r - y, cb = b - y. On a
spatially sharded rank (``spatial_axis`` bound, ``ops/conv.py``) the max
is combined over the spatial groups.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bayer_low_light_image_enhancement_tpu_torch.ops.conv import global_max

BT601 = (0.299, 0.587, 0.114)
BT709 = (0.2126, 0.7152, 0.0722)


def bayer_luma_chroma(
    planes: torch.Tensor,
    normalize: bool = True,
    weights: Tuple[float, float, float] = BT601,
    eps: float = 1e-6,
    spatial_axis=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """planes: [B, H, W, 4] (R, G1, G2, B) -> (y, cr, cb) each [B, H, W, 1]."""
    r = planes[..., 0:1]
    g = 0.5 * (planes[..., 1:2] + planes[..., 2:3])
    b = planes[..., 3:4]
    wr, wg, wb = weights
    y = wr * r + wg * g + wb * b
    if normalize:
        y = y / global_max(y, (1, 2, 3), spatial_axis).clamp_min(eps)
    return y, r - y, b - y

"""Space<->depth rearrangements (NHWC).

Port of ``bayer_low_light_image_enhancement_tpu/ops/shuffle.py``. Channel
ordering matches torch ``PixelUnshuffle``/``PixelShuffle``: the
``space_to_depth`` output channel index is ``c * r*r + i * r + j`` for input
channel ``c`` and intra-block offset ``(i, j)``; ``depth_to_space`` is its
exact inverse. The modules in ``models/`` work on NCHW and call
``F.pixel_unshuffle``/``F.pixel_shuffle``, which give the same order.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/r, W/r, C*r*r] with torch PixelUnshuffle order."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"space_to_depth: spatial dims {(h, w)} not divisible by {r}")
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C*r*r] -> [B, H*r, W*r, C] with torch PixelShuffle order."""
    b, h, w, crr = x.shape
    if crr % (r * r):
        raise ValueError(f"depth_to_space: channels {crr} not divisible by {r * r}")
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)

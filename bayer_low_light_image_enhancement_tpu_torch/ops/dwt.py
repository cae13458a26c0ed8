"""Haar discrete wavelet transforms (NHWC), in the reference's two flavours.

Port of ``bayer_low_light_image_enhancement_tpu/ops/dwt.py``:

1. batch-stacked (``haar_dwt_stack`` / ``haar_iwt_stack``): the four
   subbands concatenated on the batch axis as [LL; HL; LH; HH], each
   [B, H/2, W/2, C] (the reference's ``dwt_init`` / ``iwt_init``);
2. filter-bank (``haar_dwt_fb`` / ``haar_iwt_fb``): the orthonormal 2x2 Haar
   returning (LL, highs [..., 3] ordered LH, HL, HH), odd sizes reflect-padded
   by one.

Both reconstruct exactly: iwt(dwt(x)) == x to fp32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _quad_split(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The four polyphase components / 2: (even rows, even cols), (odd,
    even), (even, odd), (odd, odd)."""
    x = x * 0.5
    return x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]


def _interleave(ee, oe, eo, oo) -> torch.Tensor:
    """Four [B, h, w, C] phases -> [B, 2h, 2w, C] (row parity, col parity)."""
    b, h, w, c = ee.shape
    rows_e = torch.stack([ee, eo], 3).reshape(b, h, 2 * w, c)
    rows_o = torch.stack([oe, oo], 3).reshape(b, h, 2 * w, c)
    return torch.stack([rows_e, rows_o], 2).reshape(b, 2 * h, 2 * w, c)


def haar_dwt_stack(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [4B, H/2, W/2, C] stacked [LL; HL; LH; HH] on batch."""
    x1, x2, x3, x4 = _quad_split(x)
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], 0)


def haar_iwt_stack(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`haar_dwt_stack`: [4B, h, w, C] -> [B, 2h, 2w, C]."""
    if x.shape[0] % 4:
        raise ValueError(f"batch {x.shape[0]} not divisible by 4")
    x1, x2, x3, x4 = (p * 0.5 for p in x.chunk(4, 0))
    return _interleave(x1 - x2 - x3 + x4, x1 - x2 + x3 - x4, x1 + x2 - x3 - x4, x1 + x2 + x3 + x4)


def haar_dwt_fb(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal Haar: [B, H, W, C] -> (LL, highs [B, h, w, C, 3] ordered
    LH, HL, HH). Odd H / W are reflect-padded by one."""
    pad_h, pad_w = x.shape[1] % 2, x.shape[2] % 2
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect").permute(0, 2, 3, 1)
    x1, x2, x3, x4 = _quad_split(x)
    ll = x1 + x2 + x3 + x4
    lh = x1 + x2 - x3 - x4  # column difference
    hl = x1 - x2 + x3 - x4  # row difference
    hh = x1 - x2 - x3 + x4
    return ll, torch.stack([lh, hl, hh], -1)


def haar_iwt_fb(ll: torch.Tensor, highs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`haar_dwt_fb` (even-sized output)."""
    lh, hl, hh = highs.unbind(-1)
    return _interleave((ll + lh + hl + hh) * 0.5, (ll + lh - hl - hh) * 0.5,
                       (ll - lh + hl - hh) * 0.5, (ll - lh - hl + hh) * 0.5)

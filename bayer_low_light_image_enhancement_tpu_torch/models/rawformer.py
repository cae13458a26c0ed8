"""RawFormer: the canonical channel-attention U-Net (S/B/L).

Port of ``bayer_low_light_image_enhancement_tpu/models/rawformer.py``.
Contract: input [B, 1, H, W] RAW mosaic in [0, 1]*ratio (packed inside the
model by pixel_unshuffle), output [B, 3, H, W] RGB in [0, 1] (fp32), both
NCHW; H and W divisible by 16. With ``prepacked=True`` the input is the
already clamped and packed [B, 4, H/2, W/2] planes from
``kernels/bayer_pack.bayer_pack_normalize(clamp01=True)``.

Sizes: S/B/L = dim 32/48/64, heads (8, 8, 8, 8), FFN expansion 2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    ConvTransformer,
    Downsample,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import leaky_relu

SIZE_DIMS = {"S": 32, "B": 48, "L": 64}


@dataclasses.dataclass(frozen=True)
class RawFormerConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 8, 8, 8)
    ffn_expansion: int = 2
    clamp_io: bool = True
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage

    @classmethod
    def from_size(cls, size: str, **kw) -> "RawFormerConfig":
        return cls(dim=SIZE_DIMS[size.upper()], **kw)


class RawFormer(nn.Module):
    def __init__(self, config: RawFormerConfig = RawFormerConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        d, h, e = cfg.dim, cfg.num_heads, cfg.ffn_expansion
        self.embedding = Conv2d(cfg.inp_channels * 4, d, 3, **kw)
        self.conv_tran1 = ConvTransformer(d, h[0], e, **kw)
        self.down1 = Downsample(d, **kw)
        self.conv_tran2 = ConvTransformer(d * 2, h[1], e, **kw)
        self.down2 = Downsample(d * 2, **kw)
        self.conv_tran3 = ConvTransformer(d * 4, h[2], e, **kw)
        self.down3 = Downsample(d * 4, **kw)
        self.conv_tran4 = ConvTransformer(d * 8, h[3], e, **kw)
        self.up1 = Upsample2x(d * 8, d * 4, **kw)
        self.channel_reduce1 = Conv2d(d * 8, d * 4, 1, **kw)
        self.conv_tran5 = ConvTransformer(d * 4, h[2], e, **kw)
        self.up2 = Upsample2x(d * 4, d * 2, **kw)
        self.channel_reduce2 = Conv2d(d * 4, d * 2, 1, **kw)
        self.conv_tran6 = ConvTransformer(d * 2, h[1], e, **kw)
        self.up3 = Upsample2x(d * 2, d, **kw)
        self.channel_reduce3 = Conv2d(d * 2, d, 1, **kw)
        self.conv_tran7 = ConvTransformer(d, h[0], e, **kw)
        self.conv_out = Conv2d(d, cfg.out_channels * 4, 3, **kw)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters_(self, generator)

    def forward(self, x: torch.Tensor, prepacked: bool = False) -> torch.Tensor:
        if prepacked:
            return unet_forward(self, x.to(self.config.dtype))
        return unet_forward(self, pack_input(x, self.config))


def pack_input(x: torch.Tensor, cfg) -> torch.Tensor:
    """[B, 1, H, W] mosaic -> clamped (``cfg.clamp_io``) [B, 4, H/2, W/2]
    planes in ``cfg.dtype``."""
    if cfg.clamp_io:
        x = x.clamp(0.0, 1.0)
    return F.pixel_unshuffle(x.to(cfg.dtype), 2)


def unet_forward(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The RawFormer U-Net on packed planes: embedding, seven stages
    ``conv_tran1..7`` with three downsamples, three upsamples and skip
    reduces, output head and pixel_shuffle -> [B, 3, H, W] fp32 (clamped
    with ``m.config.clamp_io``). Shared by RawFormer and RawFormer-WFB,
    which differ in their stages."""
    x = m.embedding(x.contiguous(memory_format=torch.channels_last))
    c1 = m.conv_tran1(x)
    c2 = m.conv_tran2(m.down1(c1))
    c3 = m.conv_tran3(m.down2(c2))
    c4 = m.conv_tran4(m.down3(c3))
    c5 = m.conv_tran5(m.channel_reduce1(torch.cat([m.up1(c4), c3], dim=1)))
    c6 = m.conv_tran6(m.channel_reduce2(torch.cat([m.up2(c5), c2], dim=1)))
    c7 = m.conv_tran7(m.channel_reduce3(torch.cat([m.up3(c6), c1], dim=1)))
    out = F.pixel_shuffle(leaky_relu(m.conv_out(c7), 0.2), 2).float()
    return out.clamp(0.0, 1.0) if m.config.clamp_io else out


def _make_rawformer(size: str):
    def build(device=None, generator: Optional[torch.Generator] = None, **kw) -> RawFormer:
        return RawFormer(RawFormerConfig.from_size(size, **kw), device=device,
                         generator=generator)

    return build


register_model("rawformer_s", _make_rawformer("S"))
register_model("rawformer_b", _make_rawformer("B"))
register_model("rawformer_l", _make_rawformer("L"))

"""FLCA-RawFormer: the luma/chroma-guided U-Net.

Port of ``bayer_low_light_image_enhancement_tpu/models/flca_rawformer.py``.
The RawFormer skeleton where every stage's conv branch is replaced by an
FLCA branch, and all seven stages receive the (y, cr, cb) guidance
computed once from the packed Bayer planes. Nothing is clamped inside the
model (``Predictor`` clips its output).

Contract: input [B, 1, H, W] RAW mosaic in [0, 1]*ratio, output [B, 3, H,
W] fp32, both NCHW; H and W divisible by 16. Default width dim 48, heads
(8, 8, 8, 8), FFN expansion 2: TransformerBlocks at C = 48, 96, 192 run the
fused kernels K2 / K3, the C = 384 one the module path.

``GuidedStage`` and ``GuidedUNet`` are shared with
``models/multilvl_flca.py`` and ``models/truecolor.py``.

``FLCARawFormerConfig.spatial_axis`` names the mesh axes of spatially
sharded inference (H, or H and W; ``parallel/tiled.make_tiled_forward``
binds them): the luma max, the guidance resizes and the SE pools then
cross the spatial groups, the convs exchange halos, and the
TransformerBlocks take the module path. Parameter names do not depend on
it, so a sharded model loads the monolithic ``state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    Downsample,
    TransformerBlock,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import leaky_relu
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import FLCA, nchw, nhwc
from bayer_low_light_image_enhancement_tpu_torch.ops.luma import bayer_luma_chroma


class GuidedStage(nn.Module):
    """A Conv_Transformer whose conv branch is a guided attention module
    ``FLCA(feat, *guide)`` beside the TransformerBlock -> concat -> 1x1
    reduce -> 3x3 + LeakyReLU."""

    def __init__(self, dim: int, flca: nn.Module, num_heads: int = 8, ffn_expansion: int = 2,
                 log_temperature: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.FLCA = flca
        self.Transformer = TransformerBlock(dim, num_heads, ffn_expansion, log_temperature, **kw)
        self.channel_reduce = Conv2d(dim * 2, dim, 1, **kw)
        self.Conv_out = Conv2d(dim, dim, 3, **kw)

    def forward(self, feat: torch.Tensor, *guide: torch.Tensor) -> torch.Tensor:
        flca = self.FLCA(feat, *guide)
        trans = self.Transformer(feat).to(flca.dtype)
        x = self.channel_reduce(torch.cat([flca, trans], 1))
        return leaky_relu(self.Conv_out(x), 0.2)


class FLCAStage(GuidedStage):
    """The FLCA-RawFormer stage: the FLCA branch."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2, **kw):
        super().__init__(dim, FLCA(dim, **kw), num_heads, ffn_expansion, **kw)


class GuidedUNet(nn.Module):
    """The RawFormer U-Net whose seven stages all take the guidance planes:
    ``stage(dim, heads)`` builds a stage, ``down(dim)`` a downsample;
    ``spatial``: the bound spatial axes of a sharded rank (the luma max)."""

    spatial = None

    def build_unet(self, cfg, stage: Callable[[int, int], nn.Module],
                   down: Callable[[int], nn.Module], kw) -> None:
        d, h = cfg.dim, cfg.num_heads
        self.embedding = Conv2d(cfg.inp_channels * 4, d, 3, **kw)
        self.conv_tran1 = stage(d, h[0])
        self.down1 = down(d)
        self.conv_tran2 = stage(d * 2, h[1])
        self.down2 = down(d * 2)
        self.conv_tran3 = stage(d * 4, h[2])
        self.down3 = down(d * 4)
        self.conv_tran4 = stage(d * 8, h[3])
        self.up1 = Upsample2x(d * 8, d * 4, **kw)
        self.channel_reduce1 = Conv2d(d * 8, d * 4, 1, **kw)
        self.conv_tran5 = stage(d * 4, h[2])
        self.up2 = Upsample2x(d * 4, d * 2, **kw)
        self.channel_reduce2 = Conv2d(d * 4, d * 2, 1, **kw)
        self.conv_tran6 = stage(d * 2, h[1])
        self.up3 = Upsample2x(d * 2, d, **kw)
        self.channel_reduce3 = Conv2d(d * 2, d, 1, **kw)
        self.conv_tran7 = stage(d, h[0])
        self.conv_out = Conv2d(d, cfg.out_channels * 4, 3, **kw)

    def unet(self, x_ds: torch.Tensor, *guide: torch.Tensor) -> torch.Tensor:
        """Packed planes [B, 4, H/2, W/2] and the guidance -> ``conv_out``'s
        output [B, 12, H/2, W/2] (before the head's activation)."""
        c1 = self.conv_tran1(self.embedding(x_ds), *guide)
        c2 = self.conv_tran2(self.down1(c1), *guide)
        c3 = self.conv_tran3(self.down2(c2), *guide)
        c4 = self.conv_tran4(self.down3(c3), *guide)
        c5 = self.conv_tran5(self.channel_reduce1(torch.cat([self.up1(c4), c3], 1)), *guide)
        c6 = self.conv_tran6(self.channel_reduce2(torch.cat([self.up2(c5), c2], 1)), *guide)
        c7 = self.conv_tran7(self.channel_reduce3(torch.cat([self.up3(c6), c1], 1)), *guide)
        return self.conv_out(c7)


def pack_planes(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, 1, H, W] mosaic -> [B, 4, H/2, W/2] (R, G1, G2, B) planes in
    ``dtype``, channels_last; no clamp."""
    return F.pixel_unshuffle(x.to(dtype), 2).contiguous(memory_format=torch.channels_last)


def luma_guidance(x_ds: torch.Tensor, dtype: torch.dtype, spatial_axis=None):
    """(y, cr, cb) [B, 1, H/2, W/2] from the packed planes: BT.601 luma,
    per-image max normalised (over the spatial groups of a bound
    ``spatial_axis``), computed in fp32 and cast to ``dtype``."""
    return tuple(nchw(t).to(dtype)
                 for t in bayer_luma_chroma(nhwc(x_ds).float(), spatial_axis=spatial_axis))


@dataclasses.dataclass(frozen=True)
class FLCARawFormerConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 8, 8, 8)
    ffn_expansion: int = 2
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py): None,
    # the H axis name, or an (h, w) pair of names.
    spatial_axis: Optional[object] = None


class FLCARawFormer(GuidedUNet):
    # The JAX params importer ``Predictor.from_jax_params`` calls.
    state_dict_from_jax = staticmethod(jax_params.flca_state_dict_from_jax)

    def __init__(self, config: FLCARawFormerConfig = FLCARawFormerConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        self.build_unet(cfg, lambda d, h: FLCAStage(d, h, cfg.ffn_expansion, **kw),
                        lambda d: Downsample(d, **kw), kw)
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_ds = pack_planes(x, self.config.dtype)
        guide = luma_guidance(x_ds, self.config.dtype, self.spatial)
        out = leaky_relu(self.unet(x_ds, *guide), 0.2)
        return F.pixel_shuffle(out, 2).float()


def _build(device=None, generator: Optional[torch.Generator] = None, **kw) -> FLCARawFormer:
    return FLCARawFormer(FLCARawFormerConfig(**kw), device=device, generator=generator)


register_model("flca_rawformer", _build)

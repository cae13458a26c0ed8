"""Transformer-FLCA U-Net: residual conv / SE U-Net over packed planes with a
token-MHSA bottleneck (raw-domain).

Port of ``bayer_low_light_image_enhancement_tpu/models/flca_unet.py``:
three encoder stages (a 3x3 conv, ``ResCA`` blocks of dilation 1 / 2 with
0.2-scaled residuals and an SE gate, an FLCA guided by the packed planes'
luma and chroma, a stride-2 conv), a stride-2 bottleneck conv, one token
transformer (0.2 residual scales) at 1/16 of the packed resolution, three
decoder stages (``Upsample2x``, bilinear re-alignment to the skip where
sizes differ, concat, conv, GELU, two ``ResCA``) and a conv tail.
``guidance="pool"`` (``flca_unet``) splits the luma by a 3x3 box filter
(``PoolFLCA``) and adds the input back; ``guidance="dwt"``
(``unet_luma_dwt``) takes ``ops/flca.FLCA``'s Haar split and replaces the
identity residual by a learned ``enhTail`` branch of the input.

Contract: input NCHW [B, 4, H, W] packed planes (R, G1, G2, B), any H, W
(odd sizes re-align by bilinear resizes); output [B, 4, H, W] fp32. The
parameters carry the reference's PyTorch names (``enc1.blocks.0.rb.body.0``,
``trans.attn.in_proj_weight``, ``dec1.fuse.2``, ``tail.0``, ``enhTail.2``),
which the JAX package's ``import_flca_unet_state_dict`` reads. No hand
kernel runs in this model.

``FLCAUNetConfig.spatial_axis`` names the mesh axes of spatially sharded
inference (``parallel/tiled.py``). Bound: the luma max, the guidance
resizes and the SE pools cross the spatial groups, the convs (strided and
dilated too) exchange halos, the bottleneck token attention is gather-kv
(``TokenTransformer``); the Haar DWT of ``unet_luma_dwt``'s FLCA stays
local. A shard's packed H and W are multiples of 16 (four stride-2
convs), so ``align`` never resizes there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.flca_rawformer import luma_guidance
from bayer_low_light_image_enhancement_tpu_torch.models.luma_variants import (
    TokenTransformer,
    guidance_at,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import (
    FLCA,
    SqueezeExcite,
    frequency_split,
    nchw,
    nhwc,
    resize_bilinear,
)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in fp32, back in x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def align(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """NCHW x bilinearly resized to ``like``'s H, W where they differ."""
    return nchw(resize_bilinear(nhwc(x), *like.shape[-2:]))


class PoolFLCA(nn.Module):
    """FLCA with a 3x3 box split of the luma:
    ``feat (1 + alpha sigmoid(low) + beta tanh(high) + gamma sigmoid(chroma))``
    (bias-free 3x3 convs ``low_attn.0`` / ``high_attn.0`` /
    ``chroma_attn.0``; the fp32 balances make the sum fp32), then the SE
    gate ``se``; ``spatial``: the bound axes of a sharded rank."""

    spatial = None

    def __init__(self, c: int, *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.low_attn = nn.Sequential(Conv2d(1, c, 3, bias=False, **kw))
        self.high_attn = nn.Sequential(Conv2d(1, c, 3, bias=False, **kw))
        self.chroma_attn = nn.Sequential(Conv2d(2, c, 3, bias=False, **kw))
        self.se = SqueezeExcite(c, **kw)
        for name in ("alpha", "beta", "gamma"):
            setattr(self, name, nn.Parameter(torch.ones((), device=device, dtype=dtype)))

    def forward(self, feat, y, cr, cb):
        y, cr, cb = guidance_at(feat, y, cr, cb, self.spatial)
        y_low, y_high = frequency_split(y, 3, self.spatial)
        a_low = torch.sigmoid(self.low_attn(y_low).float())
        a_high = torch.tanh(self.high_attn(y_high).float())
        a_chr = torch.sigmoid(self.chroma_attn(torch.cat([cr, cb], 1)).float())
        # Each map rounds to the compute dtype before the fp32 balances.
        a_low, a_high, a_chr = (a.to(feat.dtype).float() for a in (a_low, a_high, a_chr))
        spatial = (1.0 + self.alpha.float() * a_low + self.beta.float() * a_high
                   + self.gamma.float() * a_chr)
        x = feat * spatial.to(feat.dtype)
        return x * self.se(x)


class ResBlock(nn.Module):
    """``x + 0.2 conv3x3(GELU(conv3x3_dilated(x)))`` held as the reference's
    ``body`` Sequential (convs at 0 and 2)."""

    def __init__(self, c: int, dilation: int = 1, residual_scale: float = 0.2,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.scale = residual_scale
        self.body = nn.Sequential(Conv2d(c, c, 3, dilation=dilation, **kw), nn.GELU(),
                                  Conv2d(c, c, 3, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body[2](gelu(self.body[0](x))) * self.scale


class ResCA(nn.Module):
    """``ResBlock`` ``rb`` then the SE gate ``se``: ``x se + x``."""

    def __init__(self, c: int, dilation: int = 1, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.rb = ResBlock(c, dilation, **kw)
        self.se = SqueezeExcite(c, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.rb(x)
        return x * self.se(x) + x


class EncoderStage(nn.Module):
    """``in_conv``, ``blocks`` (ResCA, dilation 1, 2, 1, ...), ``flca``, then
    the stride-2 ``down``; -> (downsampled, skip)."""

    def __init__(self, cin: int, cout: int, num_blocks: int, guidance: str,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.in_conv = Conv2d(cin, cout, 3, **kw)
        self.blocks = nn.Sequential(*(ResCA(cout, 1 if i % 2 == 0 else 2, **kw)
                                      for i in range(num_blocks)))
        self.flca = FLCA(cout, **kw) if guidance == "dwt" else PoolFLCA(cout, **kw)
        self.down = Conv2d(cout, cout, 3, stride=2, **kw)

    def forward(self, x, *guide):
        skip = self.flca(self.blocks(self.in_conv(x)), *guide)
        return self.down(skip), skip


class DecoderStage(nn.Module):
    """``up``, re-aligned to the skip, concat, then ``fuse`` (conv, GELU,
    ResCA dilation 1, ResCA dilation 2)."""

    def __init__(self, cin: int, cout: int, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.up = Upsample2x(cin, cout, **kw)
        self.fuse = nn.Sequential(Conv2d(2 * cout, cout, 3, **kw), nn.GELU(),
                                  ResCA(cout, 1, **kw), ResCA(cout, 2, **kw))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = align(self.up(x), skip)
        x = gelu(self.fuse[0](torch.cat([x, skip.to(x.dtype)], 1)))
        return self.fuse[3](self.fuse[2](x))


@dataclasses.dataclass(frozen=True)
class FLCAUNetConfig:
    in_ch: int = 4
    out_ch: int = 4
    base: int = 48
    blocks: Tuple[int, int, int] = (3, 3, 3)
    heads: int = 4
    guidance: str = "pool"  # "pool" (flca_unet) or "dwt" (unet_luma_dwt)
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py): None,
    # the H axis name, or an (h, w) pair of names.
    spatial_axis: Optional[object] = None


class TransformerFLCAUNet(nn.Module):
    state_dict_from_jax = staticmethod(jax_params.flca_unet_state_dict_from_jax)
    spatial = None  # the bound axes of a sharded rank (the luma max)

    def __init__(self, config: FLCAUNetConfig = FLCAUNetConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.guidance not in ("pool", "dwt"):
            raise ValueError(f"guidance must be 'pool' or 'dwt', got {config.guidance!r}")
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        c, g = cfg.base, cfg.guidance
        self.enc1 = EncoderStage(cfg.in_ch, c, cfg.blocks[0], g, **kw)
        self.enc2 = EncoderStage(c, 2 * c, cfg.blocks[1], g, **kw)
        self.enc3 = EncoderStage(2 * c, 4 * c, cfg.blocks[2], g, **kw)
        self.down_bott = Conv2d(4 * c, 4 * c, 3, stride=2, **kw)
        self.trans = TokenTransformer(4 * c, cfg.heads, residual_scale=0.2, norms=("ln1", "ln2"),
                                      **kw)
        self.up_bott = Upsample2x(4 * c, 4 * c, **kw)
        self.dec3 = DecoderStage(4 * c, 4 * c, **kw)
        self.dec2 = DecoderStage(4 * c, 2 * c, **kw)
        self.dec1 = DecoderStage(2 * c, c, **kw)
        self.tail = nn.Sequential(Conv2d(c, c // 2, 3, **kw), nn.GELU(),
                                  Conv2d(c // 2, cfg.out_ch, 1, **kw))
        if g == "dwt":
            self.enhTail = nn.Sequential(Conv2d(cfg.in_ch, c // 2, 3, **kw), nn.GELU(),
                                         Conv2d(c // 2, cfg.out_ch, 1, **kw))
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = x.to(cfg.dtype).contiguous(memory_format=torch.channels_last)
        guide = luma_guidance(x, cfg.dtype, self.spatial)
        x1, s1 = self.enc1(x, *guide)
        x2, s2 = self.enc2(x1, *guide)
        x3, s3 = self.enc3(x2, *guide)
        b = align(self.up_bott(self.trans(self.down_bott(x3))), x3)
        d = self.dec1(self.dec2(self.dec3(b, s3), s2), s1)
        out = self.tail[2](gelu(self.tail[0](d)))
        if cfg.guidance == "dwt":
            out = out + self.enhTail[2](gelu(self.enhTail[0](x)))
        elif cfg.in_ch == cfg.out_ch:
            out = out + x
        return out.float()


def _builder(guidance: str):
    def build(device=None, generator: Optional[torch.Generator] = None,
              **kw) -> TransformerFLCAUNet:
        return TransformerFLCAUNet(FLCAUNetConfig(guidance=guidance, **kw), device=device,
                                   generator=generator)
    return build


register_model("flca_unet", _builder("pool"), raw_domain=True)
register_model("unet_luma_dwt", _builder("dwt"), raw_domain=True)

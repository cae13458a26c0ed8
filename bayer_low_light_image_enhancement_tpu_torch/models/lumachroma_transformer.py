"""BayerLumaChromaTransformer: InstanceNorm U-Net over packed planes with a
multi-kernel FLCA and local-enhance token transformers (raw-domain).

Port of ``bayer_low_light_image_enhancement_tpu/models/lumachroma_transformer.py``:
three encoder stages (a 3x3 conv, ``num_blocks`` InstanceNorm conv blocks,
a token transformer beside a depthwise local-enhance branch, an FLCA whose
luma split takes box filters of 7, 15 and 31 taps with InstanceNorm'd
attention maps and a 1x1 ``refine``, a stride-2 conv), a bottleneck
(stride-2 conv, transformer, FLCA, ``Upsample2x``), three decoder stages
(``Upsample2x``, bilinear re-alignment where sizes differ, concat, two
conv -> InstanceNorm -> GELU) and a conv tail, plus the input (or its 1x1
projection where the channel counts differ).

The token transformers attend over every pixel of their stage: at 512^2
mosaics ``enc1.trans`` has N = 65536 tokens, so ``token_attention`` runs
in query-row chunks of at most ``chunk_bytes`` (1 GiB) of scores,
recomputed in backward.

Contract: input NCHW [B, 4, H, W] packed planes, any H, W; output
[B, 4, H, W] fp32. The parameters carry the reference's PyTorch names
(``enc1.blocks.0.3``, ``enc1.trans.local_enhance.0``,
``bottleneck.conv_up``, ``dec1.fuse.3``, ``tail.2``), which the JAX
package's ``import_lumachroma_transformer_state_dict`` reads. No hand
kernel runs in this model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.flca_rawformer import luma_guidance
from bayer_low_light_image_enhancement_tpu_torch.models.flca_unet import align, gelu
from bayer_low_light_image_enhancement_tpu_torch.models.luma_variants import (
    TokenTransformer,
    guidance_at,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import global_mean, leaky_relu
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import frequency_split


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per image and channel over H, W of NCHW x, no affine, in fp32 and
    back in x's dtype, with the JAX package's one-pass variance
    ``E[x^2] - mu^2`` (``F.instance_norm`` takes the two-pass one)."""
    xf = x.float()
    mu = global_mean(xf, (2, 3))
    var = global_mean(xf * xf, (2, 3)) - mu * mu
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class MultiKernelFLCA(nn.Module):
    """``out = feat (1 + sigmoid(IN(low)) + tanh(IN(high)) + sigmoid(IN(chroma)))``,
    then ``out + refine(out)``: ``low`` the 15-tap box filter of the luma,
    ``high`` its residues under each of ``freq_kernels`` (channels), the
    maps from bias-free 3x3 convs (``low_attn.0``, ...), ``refine`` a
    bias-free 1x1; the sum in the compute dtype."""

    def __init__(self, c: int, freq_kernels: Tuple[int, ...] = (7, 15, 31),
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.freq_kernels = tuple(freq_kernels)
        self.low_attn = nn.Sequential(Conv2d(1, c, 3, bias=False, **kw))
        self.high_attn = nn.Sequential(Conv2d(len(freq_kernels), c, 3, bias=False, **kw))
        self.chroma_attn = nn.Sequential(Conv2d(2, c, 3, bias=False, **kw))
        self.refine = Conv2d(c, c, 1, bias=False, **kw)

    def forward(self, feat, y, cr, cb):
        y, cr, cb = guidance_at(feat, y, cr, cb)
        low, _ = frequency_split(y, 15)
        highs = torch.cat([frequency_split(y, k)[1] for k in self.freq_kernels], 1)
        low_a = torch.sigmoid(instance_norm(self.low_attn(low)).float()).to(feat.dtype)
        high_a = torch.tanh(instance_norm(self.high_attn(highs)).float()).to(feat.dtype)
        chroma_a = torch.sigmoid(
            instance_norm(self.chroma_attn(torch.cat([cr, cb], 1))).float()).to(feat.dtype)
        out = feat * (1.0 + low_a + high_a + chroma_a)
        return out + self.refine(out)


def in_conv_block(cin: int, cout: int, kw) -> nn.Sequential:
    """The reference's ``Sequential(conv, IN, LeakyReLU, conv, IN,
    LeakyReLU)`` (convs at 0 and 3); run by ``in_conv_forward``."""
    return nn.Sequential(Conv2d(cin, cout, 3, **kw), nn.InstanceNorm2d(cout), nn.LeakyReLU(0.2),
                         Conv2d(cout, cout, 3, **kw), nn.InstanceNorm2d(cout), nn.LeakyReLU(0.2))


def in_conv_forward(block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    x = leaky_relu(instance_norm(block[0](x)), 0.2)
    return leaky_relu(instance_norm(block[3](x)), 0.2)


class EncoderStage(nn.Module):
    """``in_conv``, ``blocks``, ``trans`` (local-enhance), ``flca``, ``down``;
    -> (downsampled, skip)."""

    def __init__(self, cin: int, cout: int, cfg, kw):
        super().__init__()
        self.in_conv = Conv2d(cin, cout, 3, **kw)
        self.blocks = nn.ModuleList(in_conv_block(cout, cout, kw) for _ in range(cfg.num_blocks))
        self.trans = TokenTransformer(cout, cfg.heads, local=True, **kw)
        self.flca = MultiKernelFLCA(cout, cfg.freq_kernels, **kw)
        self.down = Conv2d(cout, cout, 3, stride=2, **kw)

    def forward(self, x, *guide):
        x = self.in_conv(x)
        for block in self.blocks:
            x = in_conv_forward(block, x)
        skip = self.flca(self.trans(x), *guide)
        return self.down(skip), skip


class Bottleneck(nn.Module):
    """``conv_down`` (stride 2), ``trans``, ``flca``, ``conv_up``."""

    def __init__(self, c: int, cfg, kw):
        super().__init__()
        self.conv_down = Conv2d(c, c, 3, stride=2, **kw)
        self.trans = TokenTransformer(c, cfg.heads, local=True, **kw)
        self.flca = MultiKernelFLCA(c, cfg.freq_kernels, **kw)
        self.conv_up = Upsample2x(c, c, **kw)

    def forward(self, x, *guide):
        return self.conv_up(self.flca(self.trans(self.conv_down(x)), *guide))


class DecoderStage(nn.Module):
    """``up``, re-aligned to the skip, concat, ``fuse`` (conv, IN, GELU,
    conv, IN, GELU; convs at 0 and 3)."""

    def __init__(self, cin: int, cout: int, kw):
        super().__init__()
        self.up = Upsample2x(cin, cout, **kw)
        self.fuse = nn.Sequential(Conv2d(2 * cout, cout, 3, **kw), nn.InstanceNorm2d(cout),
                                  nn.GELU(), Conv2d(cout, cout, 3, **kw), nn.InstanceNorm2d(cout),
                                  nn.GELU())

    def forward(self, x, skip):
        x = align(self.up(x), skip)
        x = gelu(instance_norm(self.fuse[0](torch.cat([x, skip.to(x.dtype)], 1))))
        return gelu(instance_norm(self.fuse[3](x)))


@dataclasses.dataclass(frozen=True)
class LumaChromaTransformerConfig:
    in_ch: int = 4
    out_ch: int = 4
    base: int = 48
    num_blocks: int = 2
    freq_kernels: Tuple[int, ...] = (7, 15, 31)
    heads: int = 4
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage


class BayerLumaChromaTransformer(nn.Module):
    state_dict_from_jax = staticmethod(jax_params.lumachroma_state_dict_from_jax)

    def __init__(self, config: LumaChromaTransformerConfig = LumaChromaTransformerConfig(),
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        c = cfg.base
        self.enc1 = EncoderStage(cfg.in_ch, c, cfg, kw)
        self.enc2 = EncoderStage(c, 2 * c, cfg, kw)
        self.enc3 = EncoderStage(2 * c, 4 * c, cfg, kw)
        self.bottleneck = Bottleneck(4 * c, cfg, kw)
        self.dec3 = DecoderStage(4 * c, 4 * c, kw)
        self.dec2 = DecoderStage(4 * c, 2 * c, kw)
        self.dec1 = DecoderStage(2 * c, c, kw)
        self.tail = nn.Sequential(Conv2d(c, c // 2, 3, **kw), nn.GELU(),
                                  Conv2d(c // 2, cfg.out_ch, 1, **kw))
        if cfg.in_ch != cfg.out_ch:
            self.res_proj = Conv2d(cfg.in_ch, cfg.out_ch, 1, **kw)
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        raw = x.to(cfg.dtype).contiguous(memory_format=torch.channels_last)
        guide = luma_guidance(raw, cfg.dtype)
        x1, s1 = self.enc1(raw, *guide)
        x2, s2 = self.enc2(x1, *guide)
        x3, s3 = self.enc3(x2, *guide)
        b = align(self.bottleneck(x3, *guide), x3)
        d = self.dec1(self.dec2(self.dec3(b, s3), s2), s1)
        out = self.tail[2](gelu(self.tail[0](d)))
        res = self.res_proj(raw) if cfg.in_ch != cfg.out_ch else raw
        return (out + align(res, out)).float()


def _build(device=None, generator: Optional[torch.Generator] = None,
           **kw) -> BayerLumaChromaTransformer:
    return BayerLumaChromaTransformer(LumaChromaTransformerConfig(**kw), device=device,
                                      generator=generator)


register_model("lumachroma_transformer", _build, raw_domain=True)

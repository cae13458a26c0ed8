"""WavKAN-RawFormer: Kolmogorov-Arnold layers with learnable wavelets.

Port of ``bayer_low_light_image_enhancement_tpu/models/wavkan.py``.
``KANLinear`` computes, per (out, in) pair, a learnable-wavelet feature
``psi((x - t) / s)`` (mexican_hat / morlet / dog) weighted and summed over
the inputs, adds a plain linear term (both in fp32), then a BatchNorm over
the features. The attention / FFN / ConvTransformer / U-Net skeleton is
RawFormer's with KAN layers in place of the pointwise convs; the channel
attention is the plain ``ops.attention.channel_attention`` (its q, k, v
come from a KANLinear, not a 1x1 conv, so the fused block does not apply).
The decoder takes the encoder's head schedule unless ``ref_decoder_heads``
reproduces the reference's (channel counts passed as head counts), which a
reference ``.pth`` needs.

The wavelet term is an [pixels, out, in] fp32 tensor: at batch 2 @
512x512 the first decoder stage's ``qkv`` alone is 3.6e9 floats.
``KANLinear`` computes it in chunks of pixels, at most ``chunk_bytes`` of
it a chunk (the sum over ``in`` is per (pixel, out), so the result is the
same function); with grad enabled each chunk is recomputed in backward
(``torch.utils.checkpoint``). ``chunk_bytes = None`` computes it whole.
The BatchNorm after it takes the whole batch's statistics (the JAX
package's: biased batch variance, momentum 0.9, ``ops.rep_conv.
BatchNorm2d``). No hand kernel runs in this model.

Contract: input [B, 1, H, W] RAW mosaic, H and W divisible by 16, output
[B, 3, H, W] fp32, both NCHW (LeakyReLU head, nothing clamped).

``WavKANConfig.spatial_axis`` names the mesh axes of spatially sharded
inference (``parallel/tiled.py``). Bound: the channel attention sums its
gram and sums of squares over the spatial groups (``ops/attention.py``),
the convs (``qkv``'s and the FFN's depthwise ones among them) exchange
halos, and ``KANLinear`` and its BatchNorm (running statistics in eval
mode) are per pixel and stay local.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.core.precision import wide
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    LayerNorm2d,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.attention import channel_attention
from bayer_low_light_image_enhancement_tpu_torch.ops.rep_conv import BatchNorm2d

# fp32 wavelet term of one chunk of pixels, at most (see the module doc).
KAN_CHUNK_BYTES = 1 << 30


def wavelet_basis(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "mexican_hat":
        return (2.0 / (math.sqrt(3.0) * math.pi ** 0.25)) * (x * x - 1.0) * torch.exp(-0.5 * x * x)
    if kind == "morlet":
        return torch.exp(-0.5 * x * x) * torch.cos(5.0 * x)
    if kind == "dog":
        return -x * torch.exp(-0.5 * x * x)
    raise ValueError(f"unsupported wavelet type {kind!r}")


class KANLinear(nn.Module):
    """[B, in, H, W] -> [B, out, H, W]: per pixel
    ``sum_i psi((x_i - t_oi) / s_oi) w_oi + (x @ weight^T)_o`` in fp32, cast
    to the compute dtype, then ``bn`` (fp32; batch statistics in train mode,
    the running ones in eval mode), cast again. Parameters [out, in] as the
    reference's."""

    def __init__(self, in_features: int, out_features: int, wavelet_type: str = "mexican_hat",
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        shape = (out_features, in_features)
        self.wavelet_type, self.compute_dtype = wavelet_type, compute_dtype
        self.scale = nn.Parameter(torch.ones(shape, device=device, dtype=dtype))
        self.translation = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))
        self.wavelet_weights = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.weight = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.bn = BatchNorm2d(out_features, device=device, dtype=dtype)
        self.chunk_bytes = KAN_CHUNK_BYTES
        self.reset_parameters_from(torch.Generator().manual_seed(0))

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """``wavelet_weights`` and ``weight`` from U(+-1/sqrt(in)) (the JAX
        package's init), drawn on the CPU; ``reset_parameters_`` calls it."""
        bound = self.weight.shape[1] ** -0.5
        with torch.no_grad():
            for p in (self.wavelet_weights, self.weight):
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def _terms(self, xf: torch.Tensor, scale, translation, wavelet_w, weight) -> torch.Tensor:
        """[P, in] fp32 -> the wavelet sum plus the linear term, [P, out] fp32."""
        xs = (xf[:, None, :] - translation) / scale  # [P, out, in]
        wav = (wavelet_basis(xs, self.wavelet_type) * wavelet_w).sum(-1)
        return wav + xf @ weight.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        ft = torch.promote_types(x.dtype, torch.float32)  # fp32 (fp64 for fp64 inputs)
        xf = x.permute(0, 2, 3, 1).reshape(-1, c).to(ft)
        params = [p.to(ft) for p in (self.scale, self.translation, self.wavelet_weights,
                                     self.weight)]
        out_f = params[0].shape[0]
        if self.chunk_bytes is None:
            terms = self._terms(xf, *params)
        else:
            step = max(1, self.chunk_bytes // (out_f * c * 4))
            recompute = torch.is_grad_enabled() and (
                xf.requires_grad or any(p.requires_grad for p in params))
            parts = []
            for i in range(0, xf.shape[0], step):
                args = (xf[i:i + step], *params)
                parts.append(torch.utils.checkpoint.checkpoint(self._terms, *args,
                                                               use_reentrant=False)
                             if recompute else self._terms(*args))
            terms = torch.cat(parts)
        y = terms.to(self.compute_dtype).reshape(b, h, w, out_f).permute(0, 3, 1, 2)
        return self.bn(y).to(self.compute_dtype)


class GELU32(nn.Module):
    """Exact GELU computed in fp32 (fp64 for an fp64 input), in the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(wide(x)).to(x.dtype)


class KANAttention(nn.Module):
    """``qkv`` (KANLinear to 3C, then a 3x3 depthwise conv) -> channel
    attention with the per-head temperature ``scale`` -> KANLinear ``proj``;
    ``spatial``: the bound axes of a sharded rank (the attention's sums)."""

    spatial = None

    def __init__(self, dim: int, num_heads: int = 8, wavelet_type: str = "mexican_hat", **kw):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Sequential(KANLinear(dim, dim * 3, wavelet_type, **kw),
                                 Conv2d(dim * 3, dim * 3, 3, groups=dim * 3, **kw))
        self.scale = nn.Parameter(torch.ones(num_heads, 1, 1, device=kw.get("device"),
                                             dtype=kw.get("dtype", torch.float32)))
        self.proj = KANLinear(dim, dim, wavelet_type, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).permute(0, 2, 3, 1).chunk(3, dim=-1)
        out = channel_attention(q, k, v, self.scale, self.num_heads, self.spatial)
        return self.proj(out.permute(0, 3, 1, 2))


class KANFFN(nn.Module):
    """KANLinear to ``expansion`` x C -> 3x3 depthwise -> exact GELU (fp32)
    -> KANLinear back, as the reference's Sequential ``net``."""

    def __init__(self, dim: int, expansion: int = 4, wavelet_type: str = "mexican_hat", **kw):
        super().__init__()
        hidden = dim * expansion
        self.net = nn.Sequential(KANLinear(dim, hidden, wavelet_type, **kw),
                                 Conv2d(hidden, hidden, 3, groups=hidden, **kw), GELU32(),
                                 KANLinear(hidden, dim, wavelet_type, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class KANTransformer(nn.Module):
    """Pre-LN residual block: ``x + attn(norm1(x))`` then ``+ ffn(norm2(.))``."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 wavelet_type: str = "mexican_hat", *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.attn = KANAttention(dim, num_heads, wavelet_type, **kw)
        self.norm2 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.ffn = KANFFN(dim, ffn_expansion, wavelet_type, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x + self.attn(self.norm1(x).to(cd))
        return x + self.ffn(self.norm2(x).to(cd))


class KANConvTransformer(nn.Module):
    """Dual branch: a 3x3 ``conv`` beside the KAN ``transformer`` -> concat
    -> KANLinear ``reduce`` -> 3x3 + LeakyReLU (``out``)."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 wavelet_type: str = "mexican_hat", **kw):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, **kw)
        self.transformer = KANTransformer(dim, num_heads, ffn_expansion, wavelet_type, **kw)
        self.reduce = KANLinear(dim * 2, dim, wavelet_type, **kw)
        self.out = nn.Sequential(Conv2d(dim, dim, 3, **kw), nn.LeakyReLU(0.2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.conv(x), self.transformer(x)], 1)
        return self.out(self.reduce(y))


class KANDownsample(nn.Module):
    """3x3 conv (with bias) C -> C/2, then pixel_unshuffle(2)."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.net = nn.Sequential(Conv2d(dim, dim // 2, 3, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_unshuffle(self.net(x), 2).contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class WavKANConfig:
    in_ch: int = 1
    out_ch: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 16, 32, 32)
    ffn_expansion: int = 2
    wavelet_type: str = "mexican_hat"
    # The reference decoder's head schedule: dim*4 / dim*2 / dim heads at
    # widths dim*8 / dim*4 / dim*2 (channel counts passed as head counts);
    # needed to load a reference .pth (temperature shapes follow heads).
    ref_decoder_heads: bool = False
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py): None,
    # the H axis name, or an (h, w) pair of names.
    spatial_axis: Optional[object] = None


class WavKANRawFormer(nn.Module):
    state_dict_from_jax = staticmethod(jax_params.wavkan_state_dict_from_jax)

    def __init__(self, config: WavKANConfig = WavKANConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        d, h = cfg.dim, cfg.num_heads

        def stage(dim, heads):
            return KANConvTransformer(dim, heads, cfg.ffn_expansion, cfg.wavelet_type, **kw)

        dec_heads = (d * 4, d * 2, d) if cfg.ref_decoder_heads else (h[2], h[1], h[0])
        self.embed = Conv2d(cfg.in_ch * 4, d, 3, **kw)
        self.encoder = nn.ModuleList(stage(d << i, h[i]) for i in range(3))
        self.downsamples = nn.ModuleList(KANDownsample(d << i, **kw) for i in range(3))
        self.bottleneck = stage(d * 8, h[3])
        self.upsamples = nn.ModuleList(Upsample2x(i, o, **kw) for i, o in
                                       ((d * 8, d * 4), (d * 8, d * 2), (d * 4, d)))
        self.decoder = nn.ModuleList(stage(c, hd) for c, hd in
                                     zip((d * 8, d * 4, d * 2), dec_heads))
        self.output = nn.Sequential(Conv2d(d * 2, cfg.out_ch * 4, 3, **kw), nn.LeakyReLU(0.2))
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pixel_unshuffle(x.to(self.config.dtype), 2)
        x = self.embed(x.contiguous(memory_format=torch.channels_last))
        features = []
        for enc, down in zip(self.encoder, self.downsamples):
            features.append(x)
            x = down(enc(x))
        x = self.bottleneck(x)
        for up, dec, skip in zip(self.upsamples, self.decoder, reversed(features)):
            x = dec(torch.cat([up(x), skip], 1))
        return F.pixel_shuffle(self.output(x), 2).float()


def _build(device=None, generator: Optional[torch.Generator] = None, **kw) -> WavKANRawFormer:
    return WavKANRawFormer(WavKANConfig(**kw), device=device, generator=generator)


register_model("wavkan_rawformer", _build)

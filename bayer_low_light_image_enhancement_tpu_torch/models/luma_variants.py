"""Luma-MHSA RawFormer: token self-attention guided by luminance.

Port of the luminance-aware MHSA half of
``bayer_low_light_image_enhancement_tpu/models/luma_variants.py``: a
RawFormer-shaped U-Net whose blocks are *token* self-attention (over pixel
tokens, not channels) with luma FiLM conditioning (gamma / beta from a
conv net over pooled luma) and a centred inverse-luma query bias scaled by
a learned ``alpha``. The luma comes from 3x3 CFA extraction convs over the
full mosaic, min-max normalised per image, and is average-pooled to every
stage's resolution. The decoder's ``proj2`` / ``proj3`` take the
consistent concat widths dim*4 / dim*2 (the reference declares dim*6 /
dim*3, which its own forward cannot reach).

Token attention holds [B, heads, N, N] scores, N the stage's pixel count:
at a 512x512 input the first stage's N is 65536. ``LuminanceAwareMHSA``
computes them in chunks of query rows, at most ``chunk_bytes`` of fp32
scores a chunk (each row's softmax is complete within the row, so the
result is the same function); with grad enabled each chunk is recomputed
in backward (``torch.utils.checkpoint``), so the scores are never all
kept. ``chunk_bytes = None`` computes them whole. The products are plain
fp32 matmuls as in the JAX package; no hand kernel runs in this model.

Contract: input [B, 1, H, W] RAW mosaic, H and W divisible by 16, output
[B, 3, H, W] fp32, both NCHW; nothing is clamped inside the model.
``SimpleFLCAUNet`` (the file's other model, raw-domain) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Conv2d,
    ConvFFN,
    Downsample,
    LayerNorm2d,
    Upsample2x,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import (
    conv2d,
    global_max,
    global_mean,
    global_min,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.luma import BT601

# fp32 scores of one chunk of query rows, at most (see the module doc).
ATTN_CHUNK_BYTES = 1 << 30

# 3x3 CFA extraction taps per pattern: positions of the nonzero weights in
# the 3x3 kernel for each of r / g / b.
_CFA_TAPS = {
    "rggb": {"r": [((0, 0), 1.0)], "g": [((0, 1), 0.5), ((1, 0), 0.5)], "b": [((1, 1), 1.0)]},
    "bggr": {"b": [((0, 0), 1.0)], "g": [((0, 1), 0.5), ((1, 0), 0.5)], "r": [((1, 1), 1.0)]},
    "grbg": {"g": [((0, 0), 0.5), ((1, 1), 0.5)], "r": [((0, 1), 1.0)], "b": [((1, 0), 1.0)]},
    "gbrg": {"g": [((0, 0), 0.5), ((1, 1), 0.5)], "b": [((0, 1), 1.0)], "r": [((1, 0), 1.0)]},
}


def bayer_luma_cfa(mosaic: torch.Tensor, pattern: str = "rggb") -> torch.Tensor:
    """[B, 1, H, W] mosaic -> [B, 1, H, W] fp32 luma: a 3x3 CFA conv (stride
    1, zero padding 1) to r, g, b, their BT.601 sum, min-max normalised per
    image. As in the reference the taps are the same at every pixel,
    whatever its CFA phase."""
    taps = _CFA_TAPS[pattern.lower()]
    kernel = torch.zeros(3, 3, 1, 3)  # HWIO
    for ci, ch in enumerate("rgb"):
        for (i, j), wgt in taps[ch]:
            kernel[i, j, 0, ci] = wgt
    rgb = conv2d(mosaic.float().permute(0, 2, 3, 1), kernel.to(mosaic.device))
    luma = (rgb * torch.tensor(BT601, device=mosaic.device)).sum(-1, keepdim=True)
    lo = global_min(luma, (1, 2, 3))
    hi = global_max(luma, (1, 2, 3))
    return ((luma - lo) / (hi - lo + 1e-6)).permute(0, 3, 1, 2)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k mean of NCHW x, computed in fp32, in x's dtype."""
    return F.avg_pool2d(x.float(), k, k).to(x.dtype)


class LumaCond(nn.Module):
    """FiLM gamma / beta [B, inner, H, W] from luma [B, 1, H, W]: two 3x3
    convs + ReLU (``net.0`` / ``net.2``), then 1x1 ``gamma`` and ``beta``."""

    def __init__(self, inner: int, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        hidden = max(16, inner // 2)
        self.net = nn.Sequential(Conv2d(1, hidden, 3, **kw), nn.ReLU(),
                                 Conv2d(hidden, hidden, 3, **kw), nn.ReLU())
        self.gamma = Conv2d(hidden, inner, 1, **kw)
        self.beta = Conv2d(hidden, inner, 1, **kw)

    def forward(self, luma: torch.Tensor):
        h = self.net(luma)
        return self.gamma(h), self.beta(h)


def token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk_bytes: Optional[int]) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over [B, heads, N, dh] tokens -> q's
    shape in v's dtype: fp32 scores, the softmax in fp32, its result cast
    to v's dtype before the product with v. Query rows go in chunks of at
    most ``chunk_bytes`` of scores (None: one chunk), each recomputed in
    backward when grad is enabled; the chunks take v in fp32 and cast it
    for their product, so that its gradient sums over the chunks in fp32
    (a bf16 sum over hundreds of chunks would lose the gradient's low bits
    that one product keeps). q is scaled before its product (one
    rounding apart from scaling the scores); ``torch.softmax`` subtracts
    each row's max, and its gradient is that of the JAX package's softmax
    with the max under ``stop_gradient`` (a shift of a row does not change
    its softmax)."""
    b, heads, n, dh = q.shape
    ft = torch.promote_types(q.dtype, torch.float32)  # fp32 (fp64 for fp64 inputs)
    qs = q.to(ft) * dh ** -0.5
    kt, v = k.to(ft).transpose(-1, -2).contiguous(), v.contiguous()

    def rows(qc, kt, vf):
        return torch.softmax(qc @ kt, dim=-1).to(v.dtype) @ vf.to(v.dtype)

    if chunk_bytes is None:
        return rows(qs, kt, v)
    step = max(1, chunk_bytes // (b * heads * n * 4))
    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    vf = v.to(ft)
    parts = []
    for i in range(0, n, step):
        qc = qs[:, :, i:i + step]
        parts.append(torch.utils.checkpoint.checkpoint(rows, qc, kt, vf, use_reentrant=False)
                     if recompute else rows(qc, kt, vf))
    return torch.cat(parts, dim=2)


class LuminanceAwareMHSA(nn.Module):
    """Token MHSA with luma FiLM on q, k and v and the centred inverse-luma
    query bias ``alpha * (box3x3(1 - luma) - mean)``; ``chunk_bytes``: see
    ``token_attention``."""

    def __init__(self, dim: int, num_heads: int = 8, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.num_heads, self.dh = num_heads, dim // num_heads
        inner = num_heads * self.dh
        self.to_qkv = Conv2d(dim, inner * 3, 1, **kw)
        self.luma_cond = LumaCond(inner, **kw)
        self.alpha = nn.Parameter(torch.zeros((), device=device, dtype=dtype))
        self.proj = Conv2d(inner, dim, 1, **kw)
        self.chunk_bytes = ATTN_CHUNK_BYTES

    def forward(self, x: torch.Tensor, luma: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        n, heads, dh = h * w, self.num_heads, self.dh

        def tokens(t):  # NCHW (channels_last) -> [B, heads, N, dh]
            return t.permute(0, 2, 3, 1).reshape(b, n, heads, dh).transpose(1, 2)

        q, k, v = (tokens(t) for t in self.to_qkv(x).chunk(3, dim=1))
        g, bta = (tokens(t) for t in self.luma_cond(luma))
        q, k, v = g * q + bta, g * k + bta, g * v + bta

        inv = 1.0 - luma
        box = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=x.device)
        inv = F.conv2d(inv.float(), box, padding=1).to(inv.dtype)
        inv = (inv - global_mean(inv, (1, 2, 3))).reshape(b, n)
        q = q + self.alpha.to(q.dtype) * inv[:, None, :, None]

        out = token_attention(q, k, v, self.chunk_bytes)  # [B, heads, N, dh]
        out = out.transpose(1, 2).reshape(b, h, w, heads * dh).permute(0, 3, 1, 2)
        return self.proj(out)


class LumaMHSABlock(nn.Module):
    """Pre-LN residual block: ``x + attn(norm1(x), luma)`` then
    ``+ ffn(norm2(.))``."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.attn = LuminanceAwareMHSA(dim, num_heads, **kw)
        self.norm2 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.ffn = ConvFFN(dim, dim * ffn_expansion, **kw)

    def forward(self, x: torch.Tensor, luma: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x + self.attn(self.norm1(x).to(cd), luma)
        return x + self.ffn(self.norm2(x).to(cd))


@dataclasses.dataclass(frozen=True)
class LumaMHSAConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 8, 8, 8)
    ffn_expansion: int = 2
    bayer_pattern: str = "rggb"
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage


class LumaMHSARawFormer(nn.Module):
    state_dict_from_jax = staticmethod(jax_params.luma_mhsa_state_dict_from_jax)

    def __init__(self, config: LumaMHSAConfig = LumaMHSAConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        d, h = cfg.dim, cfg.num_heads

        def block(dim, heads):
            return LumaMHSABlock(dim, heads, cfg.ffn_expansion, **kw)

        self.embedding = Conv2d(cfg.inp_channels * 4, d, 3, **kw)
        self.enc1, self.down1 = block(d, h[0]), Downsample(d, **kw)
        self.enc2, self.down2 = block(d * 2, h[1]), Downsample(d * 2, **kw)
        self.enc3, self.down3 = block(d * 4, h[2]), Downsample(d * 4, **kw)
        self.bottleneck = block(d * 8, h[3])
        self.up1, self.proj1 = Upsample2x(d * 8, d * 4, **kw), Conv2d(d * 8, d * 4, 1, **kw)
        self.dec1 = block(d * 4, h[2])
        self.up2, self.proj2 = Upsample2x(d * 4, d * 2, **kw), Conv2d(d * 4, d * 2, 1, **kw)
        self.dec2 = block(d * 2, h[1])
        self.up3, self.proj3 = Upsample2x(d * 2, d, **kw), Conv2d(d * 2, d, 1, **kw)
        self.dec3 = block(d, h[0])
        self.output = nn.Sequential(Conv2d(d, cfg.out_channels * 4, 3, **kw))
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.config.dtype
        luma = bayer_luma_cfa(x, self.config.bayer_pattern).to(cd)
        lumas = {s: avg_pool(luma, s) for s in (2, 4, 8, 16)}
        x = F.pixel_unshuffle(x.to(cd), 2).contiguous(memory_format=torch.channels_last)
        x1 = self.enc1(self.embedding(x), lumas[2])
        x2 = self.enc2(self.down1(x1), lumas[4])
        x3 = self.enc3(self.down2(x2), lumas[8])
        xb = self.bottleneck(self.down3(x3), lumas[16])
        y = self.dec1(self.proj1(torch.cat([self.up1(xb), x3], 1)), lumas[8])
        y = self.dec2(self.proj2(torch.cat([self.up2(y), x2], 1)), lumas[4])
        y = self.dec3(self.proj3(torch.cat([self.up3(y), x1], 1)), lumas[2])
        return F.pixel_shuffle(self.output(y), 2).float()


def _build(device=None, generator: Optional[torch.Generator] = None, **kw) -> LumaMHSARawFormer:
    return LumaMHSARawFormer(LumaMHSAConfig(**kw), device=device, generator=generator)


register_model("luma_mhsa_rawformer", _build)

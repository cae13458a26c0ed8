"""Frequency-aware Luma-Chroma Attention (FLCA) and SE channel attention.

Port of ``bayer_low_light_image_enhancement_tpu/ops/flca.py`` (single
device). A Haar DWT of the luma guidance yields a low band and a
high-frequency magnitude map; these plus the chroma planes are bilinearly
resized to the feature resolution and turned into spatial attention maps
that modulate the features, followed by an SE (squeeze-excitation) channel
gate. ``FLCAPyramid`` is the multi-level variant with gated,
tanh-bounded residuals.

The modules take NCHW tensors (features and the [B, 1, H, W] guidance
planes, computed once per forward at packed resolution); the DWT and the
resize run on NHWC views. Parameters carry the reference's PyTorch names
(``low_attn.0``, ``se.1`` / ``se.3``, ``freq_gate_head.{l}``,
``res_proj.0`` / ``.2``, ...).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import global_mean
from bayer_low_light_image_enhancement_tpu_torch.ops.dwt import haar_dwt_fb


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of NHWC x [B, H, W, C] to [B, h, w, C] with
    half-pixel centers, edge-clamped and without antialiasing on downsample
    (``F.interpolate(mode="bilinear", align_corners=False)``), computed in
    fp32 and cast back to x's dtype."""
    if tuple(x.shape[1:3]) == (h, w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def frequency_split(x: torch.Tensor, kernel_size: int = 3):
    """NCHW x -> (low, x - low): ``low`` the k x k box filter of each channel
    (stride 1, zero padding (k-1)//2, a fixed divisor k^2, its taps in x's
    dtype), as the JAX package's ``models/flca_unet.frequency_split``."""
    c, k = x.shape[1], kernel_size
    box = torch.full((c, 1, k, k), 1.0 / (k * k), dtype=x.dtype, device=x.device)
    low = F.conv2d(x, box, padding=(k - 1) // 2, groups=c)
    return low, x - low


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def high_magnitude(highs: torch.Tensor, eps: float) -> torch.Tensor:
    """Haar detail bands [B, h, w, C, 3] -> sqrt(sum of squares + eps)."""
    return torch.sqrt(highs.square().sum(-1) + eps)


def guide_conv(conv: nn.Module, t: torch.Tensor) -> torch.Tensor:
    """A conv over an NHWC guidance map, its output in fp32 (NCHW)."""
    return conv(nchw(t)).float()


class SqueezeExcite(nn.Sequential):
    """SE gate: global avg pool -> 1x1 -> ReLU -> 1x1 -> sigmoid, held as
    the reference's Sequential (convs at indices 1 and 3). Returns the
    [B, C, 1, 1] gate in x's dtype."""

    def __init__(self, c: int, reduction: int = 8, min_hidden: int = 8,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        hidden = max(min_hidden, c // reduction)
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        super().__init__(nn.AdaptiveAvgPool2d(1), Conv2d(c, hidden, 1, **kw), nn.ReLU(),
                         Conv2d(hidden, c, 1, **kw), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = F.relu(self[1](global_mean(x, (2, 3))))
        return torch.sigmoid(self[3](g).float()).to(x.dtype)


def _attn(cin: int, c: int, bias: bool, kw) -> nn.Sequential:
    """A guidance-attention conv held as the reference's ``<name>.0``."""
    return nn.Sequential(Conv2d(cin, c, 3, bias=bias, **kw))


class FLCA(nn.Module):
    """Frequency-aware luma-chroma attention block:
    ``feat * (1 + alpha sigmoid(low) + beta tanh(high) + gamma sigmoid(chroma))``
    then the SE gate."""

    def __init__(self, c: int, eps: float = 1e-8,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.eps, self.compute_dtype = eps, compute_dtype
        self.low_attn = _attn(1, c, False, kw)
        self.high_attn = _attn(1, c, False, kw)
        self.chroma_attn = _attn(2, c, False, kw)
        self.se = SqueezeExcite(c, **kw)
        for name in ("alpha", "beta", "gamma"):
            setattr(self, name, nn.Parameter(torch.ones((), device=device, dtype=dtype)))

    def forward(self, feat, y, cr, cb):
        hf, wf = feat.shape[-2:]
        cd = self.compute_dtype
        ll, highs = haar_dwt_fb(nhwc(y).float())
        y_low = resize_bilinear(ll, hf, wf).to(cd)
        y_high = resize_bilinear(high_magnitude(highs, self.eps), hf, wf).to(cd)
        cr_r = resize_bilinear(nhwc(cr), hf, wf).to(cd)
        cb_r = resize_bilinear(nhwc(cb), hf, wf).to(cd)
        a_low = torch.sigmoid(guide_conv(self.low_attn, y_low)).to(cd)
        a_high = torch.tanh(guide_conv(self.high_attn, y_high)).to(cd)
        a_chr = torch.sigmoid(guide_conv(self.chroma_attn, torch.cat([cr_r, cb_r], -1))).to(cd)
        # The fp32 balances promote the maps to fp32, as in the JAX package.
        spatial = (1.0 + self.alpha.float() * a_low.float() + self.beta.float() * a_high.float()
                   + self.gamma.float() * a_chr.float())
        x = feat * spatial.to(feat.dtype)
        return x * self.se(x)


class FLCAPyramid(nn.Module):
    """Multi-level FLCA: per level of a Haar pyramid of the luma, attention
    maps gated by sigmoids of pooled band statistics give a residual bounded
    by ``tanh(.) * max_residual_scale``; then a gated chroma residual and
    the SE gate."""

    def __init__(self, c: int, levels: int = 2, max_residual_scale: float = 0.2,
                 eps: float = 1e-8,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.levels, self.scale, self.eps = levels, max_residual_scale, eps
        self.compute_dtype = compute_dtype
        self.low_attn = nn.ModuleList([_attn(1, c, False, kw) for _ in range(levels)])
        self.high_attn = nn.ModuleList([_attn(1, c, False, kw) for _ in range(levels)])
        self.freq_gate_head = nn.ModuleList([Conv2d(2, 2, 1, **kw) for _ in range(levels)])
        self.chroma_attn = _attn(2, c, False, kw)
        self.chroma_gate = Conv2d(1, 1, 1, **kw)
        self.se = SqueezeExcite(c, **kw)
        self.res_proj = nn.Sequential(Conv2d(c, c, 1, **kw), nn.ReLU(), Conv2d(c, c, 1, **kw))

    def _residual(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        raw = self.res_proj[2](F.relu(self.res_proj[0](t)))
        return x + torch.tanh(raw.float()).to(x.dtype) * self.scale

    def forward(self, feat, y, cr, cb):
        hf, wf = feat.shape[-2:]
        cd = self.compute_dtype
        lows: List[torch.Tensor] = []
        highs: List[torch.Tensor] = []
        cur = nhwc(y).float()
        for _ in range(self.levels):
            cur, hb = haar_dwt_fb(cur)
            lows.append(cur)
            highs.append(high_magnitude(hb, self.eps))

        x = feat
        for l in range(self.levels):
            y_low = resize_bilinear(lows[l], hf, wf).to(cd)
            y_high = resize_bilinear(highs[l], hf, wf).to(cd)
            a_low = torch.sigmoid(guide_conv(self.low_attn[l], y_low)).to(cd)
            a_high = torch.tanh(guide_conv(self.high_attn[l], y_high)).to(cd)
            pooled = torch.cat([global_mean(y_low, (1, 2)), global_mean(y_high, (1, 2))], -1)
            gates = torch.sigmoid(guide_conv(self.freq_gate_head[l], pooled)).to(cd)
            spatial = gates[:, 0:1] * a_low + gates[:, 1:2] * a_high
            x = self._residual(x, x * spatial)

        cr_r = resize_bilinear(nhwc(cr).float(), hf, wf).to(cd)
        cb_r = resize_bilinear(nhwc(cb).float(), hf, wf).to(cd)
        a_chr = torch.sigmoid(guide_conv(self.chroma_attn, torch.cat([cr_r, cb_r], -1))).to(cd)
        chr_mag = torch.sqrt(cr_r.float() ** 2 + cb_r.float() ** 2 + self.eps)
        gamma = torch.sigmoid(guide_conv(self.chroma_gate,
                                         global_mean(chr_mag.to(cd), (1, 2)))).to(cd)
        x = self._residual(x, x * (gamma * a_chr))
        return x * self.se(x)

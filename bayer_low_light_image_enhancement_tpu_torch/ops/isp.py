"""Learned-ISP components of the TrueColor model family.

Port of ``bayer_low_light_image_enhancement_tpu/ops/isp.py``:

* ``BayerProcessor``: learnable white-balance gains, conv demosaic
  refinement, a learnable 3x4 colour matrix, BT.709 luma (per-image max
  normalised) and a learned tanh chroma extractor. ``positive_gains=True``
  is the BayerTORGB wiring: softplus-positive gains, the linear demosaic
  straight from the WB planes, and a residual GELU refine of the
  3-channel linear RGB that becomes the rgb guide (y and chroma come from
  the RGB before the refine), so ``demosaic_refine`` has other shapes;
* ``ColorCorrection``: a learnable gamma, a 1x1 colour MLP and one
  1 -> 32 -> 1 tone curve shared by the channels; ``bounded=True`` is the
  BayerTORGB [0.8, 1.2] multiplicative tone with a softplus gamma stored as
  ``gamma_param``;
* ``EnhancedFLCA``: FLCA with a 5-channel (Y, Cr, Cb, R, G) colour-guidance
  attention; ``levels > 1`` is the BayerTORGB pyramid variant.

Modules take NCHW tensors; parameters carry the reference's PyTorch names
(``demosaic_refine.0`` / ``.2``, ``chroma_extractor.0`` / ``.2``,
``color_transform.0`` / ``.2``, ``tone_curve.0`` / ``.2``, ...).

Spatially sharded inference (``spatial`` bound by
``models.common.bind_spatial``, None for the monolithic forward):
``BayerProcessor``'s luma max is combined over the spatial groups,
``EnhancedFLCA``'s resizes and SE pool are those of ``ops/flca.py``, the
convs exchange halos, and ``ColorCorrection`` is pointwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import global_max
from bayer_low_light_image_enhancement_tpu_torch.ops.dwt import haar_dwt_fb
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import (
    SqueezeExcite,
    guide_conv,
    high_magnitude,
    nhwc,
    resize_bilinear,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.luma import BT709


def _mlp(cin: int, hidden: int, cout: int, k: int, act: nn.Module, kw) -> nn.Sequential:
    """conv -> activation -> conv, held as the reference's Sequential."""
    return nn.Sequential(Conv2d(cin, hidden, k, **kw), act, Conv2d(hidden, cout, k, **kw))


class BayerProcessor(nn.Module):
    """Learned Bayer -> guidance front end: planes [B, 4, H, W] (R, G1, G2,
    B) -> (y, cr, cb, rgb_guide), [B, 1|1|1|3, H, W]."""

    spatial = None

    def __init__(self, positive_gains: bool = False, eps: float = 1e-6,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.positive_gains, self.eps, self.compute_dtype = positive_gains, eps, compute_dtype
        wb = [1.8, 1.0, 1.0, 1.6] if positive_gains else [1.0] * 4
        self.wb_gains = nn.Parameter(torch.tensor(wb, device=device, dtype=dtype))
        self.color_matrix = nn.Parameter(torch.eye(3, 4, device=device, dtype=dtype))
        if positive_gains:
            self.demosaic_refine = _mlp(3, 32, 3, 3, nn.GELU(), kw)
        else:
            self.demosaic_refine = _mlp(4, 32, 4, 3, nn.ReLU(), kw)
        self.chroma_extractor = _mlp(4, 16, 2, 3, nn.ReLU(), kw)

    def forward(self, planes: torch.Tensor):
        cd = self.compute_dtype
        gains = F.softplus(self.wb_gains) + 1e-6 if self.positive_gains else self.wb_gains
        wb = planes * gains.to(planes.dtype).view(1, 4, 1, 1)
        refined = wb
        if not self.positive_gains:
            refined = self.demosaic_refine[2](F.relu(self.demosaic_refine[0](wb)))
            refined = F.softplus(refined.float()).to(refined.dtype)

        r, b = refined[:, 0:1], refined[:, 3:4]
        g = 0.5 * (refined[:, 1:2] + refined[:, 2:3])
        rgb = torch.cat([r, g, b], 1)
        cm = self.color_matrix.to(rgb.dtype)
        rgb_linear = torch.einsum("ij,bjhw->bihw", cm[:, :3], rgb) + cm[:, 3].view(1, 3, 1, 1)

        wts = torch.tensor(BT709, device=planes.device).view(1, 3, 1, 1)
        y = (rgb_linear.float() * wts).sum(1, keepdim=True)
        y = (y / global_max(y, (1, 2, 3), self.spatial, nchw=True).clamp_min(self.eps)).to(cd)

        ch = self.chroma_extractor[0](torch.cat([r, g, b, y], 1))
        ch = torch.tanh(self.chroma_extractor[2](F.relu(ch)).float()).to(cd)
        cr, cb = ch[:, 0:1], ch[:, 1:2]

        if self.positive_gains:
            d = self.demosaic_refine[0](rgb_linear)
            d = self.demosaic_refine[2](F.gelu(d.float()).to(d.dtype))
            return y, cr, cb, rgb_linear + d
        return y, cr, cb, rgb_linear


class ColorCorrection(nn.Module):
    """Camera-aware output correction of [B, C, H, W] RGB, clipped to [0, 1]
    (compute dtype)."""

    def __init__(self, c: int = 3, bounded: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.bounded, self.compute_dtype = bounded, compute_dtype
        gamma = nn.Parameter(torch.full((), 2.2, device=device, dtype=dtype))
        setattr(self, "gamma_param" if bounded else "gamma", gamma)
        self.color_transform = _mlp(c, 64, c, 1, nn.ReLU(), kw)
        self.tone_curve = _mlp(1, 32, 1, 1, nn.ReLU(), kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if self.bounded:
            gamma = F.softplus(self.gamma_param) + 1e-6
        else:
            gamma = self.gamma
        xg = torch.pow(x.float().clamp(0.0, 1.0), 1.0 / gamma.float()).to(cd)
        xt = self.color_transform[2](F.relu(self.color_transform[0](xg)))

        # One tone curve for every channel: channels folded into the batch.
        b, c, h, w = xt.shape
        t = xt.reshape(b * c, 1, h, w)
        t = self.tone_curve[2](F.relu(self.tone_curve[0](t)))
        tone = torch.sigmoid(t.float()).to(cd).reshape(b, c, h, w)

        out = xt * (0.8 + 0.4 * tone) if self.bounded else tone
        return out.float().clamp(0.0, 1.0).to(cd)


class EnhancedFLCA(nn.Module):
    """FLCA with 5-channel colour guidance. ``levels > 1``: an N-level Haar
    pyramid of y (y_low the deepest LL, y_high the mean of the per-level
    high magnitudes), tanh-bounded frequency attention, and a tanh-bounded
    0.2-scaled residual projection before the SE gate."""

    spatial = None

    def __init__(self, c: int, levels: int = 1, eps: float = 1e-8,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.levels, self.eps, self.compute_dtype = levels, eps, compute_dtype
        self.color_attention = nn.Sequential(Conv2d(5, c, 3, **kw))
        self.low_attn = nn.Sequential(Conv2d(1, c, 3, **kw))
        self.high_attn = nn.Sequential(Conv2d(1, c, 3, **kw))
        self.se = SqueezeExcite(c, **kw)
        if levels > 1:
            self.res_proj = _mlp(c, c, c, 1, nn.ReLU(), kw)

    def forward(self, feat, y, cr, cb, rgb_guide):
        hf, wf = feat.shape[-2:]
        cd = self.compute_dtype
        pyramid = self.levels > 1

        def resized(t: torch.Tensor) -> torch.Tensor:
            return resize_bilinear(t, hf, wf, self.spatial)

        cur, high_mags = nhwc(y).float(), []
        for _ in range(max(1, self.levels)):
            cur, highs = haar_dwt_fb(cur)
            high_mags.append(resized(high_magnitude(highs, self.eps)))

        y_low = resized(cur).to(cd)
        y_high = (sum(high_mags) / len(high_mags)).to(cd)
        y_r, cr_r, cb_r, rgb_r = (resized(nhwc(t).float()).to(cd)
                                  for t in (y, cr, cb, rgb_guide))
        guidance = torch.cat([y_r, cr_r, cb_r, rgb_r[..., 0:1], rgb_r[..., 1:2]], -1)
        color_attn = torch.sigmoid(guide_conv(self.color_attention, guidance)).to(cd)

        low = torch.sigmoid(guide_conv(self.low_attn, y_low))
        high = torch.tanh(guide_conv(self.high_attn, y_high))
        freq_attn = (torch.tanh(low + high) if pyramid else low + high).to(cd)

        x = feat * (1.0 + color_attn + freq_attn)
        if pyramid:
            res = self.res_proj[2](F.relu(self.res_proj[0](x)))
            x = x + (torch.tanh(res.float()) * 0.2).to(cd)
        return x * self.se(x)

"""RawFormer-WFB: the wavelet / FFT / selective-SSM variant.

Port of ``bayer_low_light_image_enhancement_tpu/models/wfb.py``. The U-Net
skeleton is RawFormer's (``models/rawformer.unet_forward``); each stage's
transformer branch is a WMB:

  LayerNorm -> 2x-1 -> batch-stacked Haar DWT
    -> LL band:    IlluminationEstimator -> FFAB (FFT)
    -> high bands: WM (conv sandwich + Mamba scan over pixel tokens)
  -> IWT -> (x+1)/2 clamped to [0, 1] -> residual -> gated FeedForward.

Contract: input [B, 1, H, W] RAW mosaic, H and W divisible by 32 (pixel
unshuffle, three downsamples and the in-stage DWT halving), output
[B, 3, H, W] RGB in [0, 1] fp32, both NCHW. There is no ``prepacked``
entry. Parameters carry the reference's PyTorch names, so the JAX
package's ``compat/torch_import.import_wfb_state_dict`` reads
``state_dict()`` directly; the reference's dead second Mamba (``model2``)
is not built.

``RawFormerWFBConfig.ssm_kernel`` (default on) sends every Mamba scan to
the kernels S1/S2 on the card (their twins on the CPU);
``ref_token_layout`` reproduces the reference's WM token layouts.
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
    Downsample,
    LayerNorm2d,
    Upsample2x,
    reset_parameters_,
    set_fused_blocks,
)
from bayer_low_light_image_enhancement_tpu_torch.models.rawformer import pack_input, unet_forward
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import leaky_relu
from bayer_low_light_image_enhancement_tpu_torch.ops.dwt import haar_dwt_stack, haar_iwt_stack
from bayer_low_light_image_enhancement_tpu_torch.ops.fft import FFAB
from bayer_low_light_image_enhancement_tpu_torch.ops.rep_conv import GatedFeedForward
from bayer_low_light_image_enhancement_tpu_torch.ops.ssm import MambaBlock

PAD_TO = 32  # H and W of the input must be multiples of this


class IlluminationEstimator(nn.Module):
    """concat channel mean -> 1x1 -> depthwise 5x5 -> 1x1; returns
    (illu_fea [.., n_mid], illu_map [.., n_out])."""

    def __init__(self, n_in: int, n_mid: int, n_out: int, **kw):
        super().__init__()
        self.conv1 = Conv2d(n_in + 1, n_mid, 1, **kw)
        self.depth_conv = Conv2d(n_mid, n_mid, 5, groups=n_mid, **kw)
        self.conv2 = Conv2d(n_mid, n_out, 1, **kw)

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([img, img.mean(1, keepdim=True)], 1)
        illu_fea = self.depth_conv(self.conv1(x))
        return illu_fea, self.conv2(illu_fea)


class WM(nn.Module):
    """Wavelet-Mamba high-band processor: conv sandwich + residual, fp32
    LayerNorm over channels (eps 1e-5), a Mamba over the pixel tokens,
    3x3 smooth. Tokens are NHWC pixels, or with ``ref_token_layout`` the
    reference's layouts: NCHW memory read as (b, h*w, c) in, and the tokens
    transposed and read as NCHW out."""

    def __init__(self, c: int, d_state: int = 32, d_conv: int = 4, expand: int = 2,
                 ref_token_layout: bool = False, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.ref_token_layout = ref_token_layout
        self.compute_dtype = compute_dtype
        self.convb = nn.Sequential(Conv2d(c, 2 * c, 3, **kw), nn.ReLU(), Conv2d(2 * c, c, 3, **kw))
        self.ln = nn.LayerNorm(c, eps=1e-5, device=device, dtype=dtype)
        self.model1 = MambaBlock(c, d_state, d_conv, expand, **kw)
        self.smooth = Conv2d(c, c, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x = self.convb(x) + x
        if self.ref_token_layout:
            tokens = x.reshape(b, h * w, c)
        else:
            tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tokens = F.layer_norm(tokens.float(), (c,), self.ln.weight.float(), self.ln.bias.float(),
                              self.ln.eps).to(self.compute_dtype)
        tokens = self.model1(tokens)
        if self.ref_token_layout:
            out = tokens.transpose(1, 2).reshape(b, c, h, w)
        else:
            out = tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.smooth(out)


class WMB(nn.Module):
    """Wavelet-Mamba Block."""

    def __init__(self, dim: int, ffn_expansion: float = 2.66, ref_token_layout: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.illu = IlluminationEstimator(dim, dim, dim, **kw)
        # The block discards the illumination map, as the reference does, so
        # conv2 takes no part in the loss (its JAX grad is zero and Adam
        # leaves it as it is): frozen, so that DistributedDataParallel's
        # reducer waits for no grad of it.
        self.illu.conv2.requires_grad_(False)
        self.ffab = FFAB(dim, **kw)
        self.mb = WM(dim, ref_token_layout=ref_token_layout, **kw)
        self.norm2 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.ffn = GatedFeedForward(dim, ffn_expansion, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, cd = x.shape[0], self.compute_dtype
        y = 2.0 * self.norm1(x).to(cd) - 1.0
        bands = haar_dwt_stack(y.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        ll, _ = self.illu(bands[:n])
        ll = self.ffab(ll)
        high = self.mb(bands[n:])
        out = haar_iwt_stack(torch.cat([ll, high], 0).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        y = y + ((out + 1.0) / 2.0).clamp(0.0, 1.0)
        return y + self.ffn(self.norm2(y).to(cd))


class ConvWMB(nn.Module):
    """Dual-branch stage: 3x3 conv + LeakyReLU beside a WMB -> concat -> 1x1
    reduce -> 3x3 + LeakyReLU."""

    def __init__(self, dim: int, ffn_expansion: float = 2.66, ref_token_layout: bool = False,
                 **kw):
        super().__init__()
        self.conv = Conv2d(dim, dim, 3, **kw)
        self.Transformer = WMB(dim, ffn_expansion, ref_token_layout, **kw)
        self.channel_reduce = Conv2d(dim * 2, dim, 1, **kw)
        self.Conv_out = Conv2d(dim, dim, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = leaky_relu(self.conv(x), 0.2)
        trans = self.Transformer(x).to(conv.dtype)
        y = self.channel_reduce(torch.cat([conv, trans], dim=1))
        return leaky_relu(self.Conv_out(y), 0.2)


@dataclasses.dataclass(frozen=True)
class RawFormerWFBConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    ffn_expansion: float = 2.66
    clamp_io: bool = True
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Reproduce the reference WM's token layouts (checkpoint output parity).
    ref_token_layout: bool = False
    # Mamba scans through the kernels S1/S2 on the card (twins on the CPU).
    ssm_kernel: bool = True


class RawFormerWFB(nn.Module):
    # Takes the JAX {"params", "batch_stats"} variables, not params alone.
    state_dict_from_jax = staticmethod(jax_params.wfb_state_dict_from_jax)

    def __init__(self, config: RawFormerWFBConfig = RawFormerWFBConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        d, e, ref = cfg.dim, cfg.ffn_expansion, cfg.ref_token_layout
        self.embedding = Conv2d(cfg.inp_channels * 4, d, 3, **kw)
        self.conv_tran1 = ConvWMB(d, e, ref, **kw)
        self.down1 = Downsample(d, **kw)
        self.conv_tran2 = ConvWMB(d * 2, e, ref, **kw)
        self.down2 = Downsample(d * 2, **kw)
        self.conv_tran3 = ConvWMB(d * 4, e, ref, **kw)
        self.down3 = Downsample(d * 4, **kw)
        self.conv_tran4 = ConvWMB(d * 8, e, ref, **kw)
        self.up1 = Upsample2x(d * 8, d * 4, **kw)
        self.channel_reduce1 = Conv2d(d * 8, d * 4, 1, **kw)
        self.conv_tran5 = ConvWMB(d * 4, e, ref, **kw)
        self.up2 = Upsample2x(d * 4, d * 2, **kw)
        self.channel_reduce2 = Conv2d(d * 4, d * 2, 1, **kw)
        self.conv_tran6 = ConvWMB(d * 2, e, ref, **kw)
        self.up3 = Upsample2x(d * 2, d, **kw)
        self.channel_reduce3 = Conv2d(d * 2, d, 1, **kw)
        self.conv_tran7 = ConvWMB(d, e, ref, **kw)
        self.conv_out = Conv2d(d, cfg.out_channels * 4, 3, **kw)
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))
        set_fused_blocks(self, cfg.ssm_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] % PAD_TO or x.shape[-1] % PAD_TO:
            raise ValueError(f"RawFormer-WFB takes H and W divisible by {PAD_TO}, got "
                             f"{tuple(x.shape[-2:])} (Predictor: pad_to={PAD_TO})")
        return unet_forward(self, pack_input(x, self.config))


def _build(device=None, generator: Optional[torch.Generator] = None, **kw) -> RawFormerWFB:
    return RawFormerWFB(RawFormerWFBConfig(**kw), device=device, generator=generator)


register_model("rawformer_wfb", _build)

"""Frequency-domain enhancement blocks (FEB / ProcessBlock / FFAB).

Port of the FFT path of ``bayer_low_light_image_enhancement_tpu/ops/fft.py``
(the JAX package's CPU default): FEB is an fp32 island, rfft2 (ortho) over
the spatial axes, magnitude and phase through separate 1x1-conv stacks,
recomposed through cos/sin and inverse-transformed, with the stabilisation
clamps (+-10 on the signal, [0, 1e4] on the magnitude). FFAB is six
ProcessBlocks in a dense topology with channel-doubling concats. The JAX
package's DFT-matmul backend is a TPU workaround and is not ported; on the
card ``torch.fft`` runs cuFFT (the JAX package computes its FFT outside any
Pallas kernel too).

Modules are NCHW (held channels_last) with the reference's parameter names
(``process1.0`` / ``process1.2``, ``conv0.0`` / ``conv0.1``, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import gather_axis, spatial_axes


def _spectral_stack(c: int, device, dtype) -> nn.Sequential:
    """1x1 conv -> LeakyReLU(0.1) -> 1x1 conv, in fp32."""
    kw = dict(device=device, dtype=dtype, compute_dtype=torch.float32)
    return nn.Sequential(Conv2d(c, c, 1, **kw), nn.LeakyReLU(0.1), Conv2d(c, c, 1, **kw))


class FEB(nn.Module):
    """Frequency Enhancement Block; output in ``compute_dtype``.

    Spatially bound (``spatial``, ``models.common.bind_spatial``), the FFT
    needs the whole image: the block gathers its ``fpre`` map along the
    sharded axes, runs the spectrum pipeline replicated, and slices this
    rank's block of the inverse back out (the JAX package's FEB). The 1x1
    convs stay local."""

    spatial = None

    def __init__(self, c: int, *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fpre = Conv2d(c, c, 1, device=device, dtype=dtype, compute_dtype=torch.float32)
        self.process1 = _spectral_stack(c, device, dtype)
        self.process2 = _spectral_stack(c, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().clamp(-10.0, 10.0)
        pre = self.fpre(x)
        h_ax, w_ax = spatial_axes(self.spatial)
        h_local, w_local = pre.shape[-2:]
        pre = gather_axis(gather_axis(pre, h_ax, 2), w_ax, 3)
        h, w = pre.shape[-2:]
        freq = torch.fft.rfft2(pre.contiguous(), norm="ortho")
        re, im = freq.real, freq.imag
        # The DC / Nyquist bins of a real signal are real, but FFT backends
        # leave +-eps imaginary parts there, which flip the angle between
        # ~+-pi: snap near-real bins to exactly real, +0 imaginary.
        im = torch.where(im.abs() <= 1e-6 * (re.abs() + 1e-12), torch.zeros_like(im), im)
        mag = torch.sqrt(re * re + im * im) + 1e-6
        pha = torch.atan2(im, re)
        mag = self.process1(mag).clamp(0.0, 1e4)
        pha = self.process2(pha)
        spec = torch.complex(mag * torch.cos(pha), mag * torch.sin(pha))
        out = torch.fft.irfft2(spec, s=(h, w), norm="ortho")
        if h_ax is not None:
            out = out.narrow(2, h_ax.index * h_local, h_local)
        if w_ax is not None:
            out = out.narrow(3, w_ax.index * w_local, w_local)
        return (out + x).clamp(-10.0, 10.0).to(self.compute_dtype)


class ProcessBlock(nn.Module):
    """FEB -> 1x1 (``cat``) -> + x."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.frequency_process = FEB(c, **kw)
        self.cat = Conv2d(c, c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cat(self.frequency_process(x)) + x


class FFAB(nn.Module):
    """Frequency-domain dense block."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.conv0 = nn.Sequential(Conv2d(c, c, 1, **kw), ProcessBlock(c, **kw))
        self.conv1 = ProcessBlock(c, **kw)
        self.conv2 = ProcessBlock(c, **kw)
        self.conv3 = ProcessBlock(c, **kw)
        self.conv4 = nn.Sequential(ProcessBlock(2 * c, **kw), Conv2d(2 * c, c, 1, **kw))
        self.conv5 = nn.Sequential(ProcessBlock(2 * c, **kw), Conv2d(2 * c, c, 1, **kw))
        self.convout = nn.Sequential(ProcessBlock(2 * c, **kw), Conv2d(2 * c, c, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(x)
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        x4 = self.conv4(torch.cat([x2, x3], 1))
        x5 = self.conv5(torch.cat([x1, x4], 1))
        return self.convout(torch.cat([x, x5], 1))


"""Shared modules for the RawFormer model family.

Port of ``bayer_low_light_image_enhancement_tpu/models/common.py``. The
modules take NCHW tensors held in ``torch.channels_last``, so the NHWC view
of an activation (``x.permute(0, 2, 3, 1)``) is free; the ``ops`` they call
work on NHWC. Parameters carry the reference's PyTorch names, so a
reference ``.pth`` loads directly and ``compat/torch_import`` of the JAX
package maps a ``state_dict`` onto the JAX tree.

Modules take ``device`` and ``dtype`` (parameter storage), and those with
convs ``compute_dtype``; parameters are initialised by ``reset_parameters_``
from an explicit ``torch.Generator`` (torch's default conv init,
U(+-1/sqrt(fan_in)) for kernel and bias).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.kernels.fused_block import (
    attention_temperature,
    check_apply_kernel,
    fused_transformer_block,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.attention import channel_attention
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import leaky_relu
from bayer_low_light_image_enhancement_tpu_torch.ops.norm import channel_layernorm
from bayer_low_light_image_enhancement_tpu_torch.ops.ssm import MambaBlock

# TransformerBlocks with C <= FUSE_CMAX run the fused kernels: the gate of
# the JAX package's inference routing (models/fused_apply._fusable at its
# default BAYER_TPU_FUSE_CMAX). Every RawFormer-S level qualifies.
FUSE_CMAX = 256


def reset_parameters_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every conv and linear layer in ``module`` from
    ``generator``: U(+-1/sqrt(fan_in)) for weight and bias (torch's default
    conv init). Values are drawn on the CPU, so a seed gives the same
    weights on every device. A module with its own init draws it through
    its ``reset_parameters_from(generator)`` (the KAN layers). Norms,
    temperatures and the Mamba ``A_log`` / ``D`` keep their initial
    values."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters_from"):
                m.reset_parameters_from(generator)
            elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                bound = fan_in ** -0.5
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


class Conv2d(nn.Conv2d):
    """Conv with torch ``padding = dilation * (k-1) // 2`` (symmetric, also
    at stride 2, as the JAX package's ``ops/conv.conv2d``) that computes in
    ``compute_dtype`` (parameters are cast per call)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 groups: int = 1, bias: bool = True, stride: int = 1, dilation: int = 1,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
                         groups=groups, bias=bias, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.conv2d(x.to(cd), self.weight.to(cd), b, self.stride, self.padding,
                        self.dilation, self.groups)


class Linear(nn.Linear):
    """A Dense layer over the last axis that computes in ``compute_dtype``
    (parameters are cast per call)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm (torch nn.LayerNorm semantics, eps 1e-5) held as
    ``body`` like the reference. Output dtype is the input's."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.body = nn.LayerNorm(dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = channel_layernorm(x.permute(0, 2, 3, 1), self.body.weight, self.body.bias,
                              self.body.eps)
        return y.permute(0, 3, 1, 2)


class ChannelAttention(nn.Module):
    """Transposed (channel) attention: qkv 1x1 -> 3x3 depthwise -> per-head
    L2-normalised [c,c] gram -> softmax * temperature -> apply to v -> 1x1
    projection.

    ``log_temperature=True`` stores log(T) as ``log_temperature`` (zeros at
    init) and exponentiates it, as the BayerTORGB reference does; otherwise
    T is stored as ``temperature`` (ones at init)."""

    def __init__(self, dim: int, num_heads: int = 8, log_temperature: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.num_heads = num_heads
        t = torch.zeros if log_temperature else torch.ones
        name = "log_temperature" if log_temperature else "temperature"
        setattr(self, name, nn.Parameter(t(num_heads, 1, 1, device=device, dtype=dtype)))
        self.qkv = Conv2d(dim, dim * 3, 1, **kw)
        self.qkv_dwconv = Conv2d(dim * 3, dim * 3, 3, groups=dim * 3, **kw)
        self.project_out = Conv2d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv_dwconv(self.qkv(x)).permute(0, 2, 3, 1)
        q, k, v = qkv.chunk(3, dim=-1)
        temperature = attention_temperature(self._parameters)
        out = channel_attention(q, k, v, temperature, self.num_heads)
        return self.project_out(out.permute(0, 3, 1, 2))


class ConvFFN(nn.Module):
    """1x1 expand -> 3x3 depthwise -> exact GELU (fp32) -> 1x1 project."""

    def __init__(self, dim: int, hidden: int, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.pointwise1 = Conv2d(dim, hidden, 1, **kw)
        self.depthwise = Conv2d(hidden, hidden, 3, groups=hidden, **kw)
        self.pointwise2 = Conv2d(hidden, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.depthwise(self.pointwise1(x))
        h = F.gelu(h.float()).to(h.dtype)
        return self.pointwise2(h)


class TransformerBlock(nn.Module):
    """Pre-LN residual block: ``x + attn(norm1(x))`` then ``+ ffn(norm2(.))``
    (``log_temperature``: see ChannelAttention).

    Blocks with C <= FUSE_CMAX call the fused-block wrapper (kernels K2/K3
    on CUDA, their fp32 twins on the CPU; with grad enabled its
    autograd.Function, whose backward runs B1/B2); wider ones, and every
    block with ``fused`` False (``set_fused_blocks``), run the module path.
    ``apply_kernel`` ("tiled", or "pipelined" for K3P; ``set_apply_kernel``)
    picks the fused block's apply pass.
    """

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 log_temperature: bool = False,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.attn = ChannelAttention(dim, num_heads, log_temperature, **kw)
        self.norm2 = LayerNorm2d(dim, device=device, dtype=dtype)
        self.ffn = ConvFFN(dim, dim * ffn_expansion, **kw)
        self.fused = True
        self.apply_kernel = "tiled"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and x.shape[1] <= FUSE_CMAX:
            y = fused_transformer_block(
                x.permute(0, 2, 3, 1), dict(self.named_parameters()), self.num_heads,
                apply_kernel=self.apply_kernel,
            )
            return y.permute(0, 3, 1, 2)
        cd = self.compute_dtype
        x = x + self.attn(self.norm1(x).to(cd))
        return x + self.ffn(self.norm2(x).to(cd))


def set_fused_blocks(module: nn.Module, fused: bool) -> None:
    """Route every TransformerBlock and every Mamba scan in ``module``
    through the kernels (True, the default) or the module path and the scan
    twin (False)."""
    for m in module.modules():
        if isinstance(m, (TransformerBlock, MambaBlock)):
            m.fused = fused


def set_chunk_bytes(module: nn.Module, nbytes) -> None:
    """Set the byte budget of every chunked module in ``module`` (the luma
    MHSA's token attention, the KAN layers): each computes its largest
    temporary in slices of at most ``nbytes``, recomputed in backward;
    None computes it whole."""
    for m in module.modules():
        if hasattr(m, "chunk_bytes"):
            m.chunk_bytes = nbytes


def set_apply_kernel(module: nn.Module, apply_kernel: str) -> None:
    """Select the apply pass of every fused TransformerBlock in ``module``:
    "tiled" (K3, the default) or "pipelined" (K3P at C in {32, 64, 128,
    256}, K3 at the other widths). Raises ValueError for another value."""
    check_apply_kernel(apply_kernel)
    for m in module.modules():
        if isinstance(m, TransformerBlock):
            m.apply_kernel = apply_kernel


class ConvTransformer(nn.Module):
    """Dual-branch stage: 3x3 conv + LeakyReLU beside a TransformerBlock ->
    concat -> 1x1 reduce -> 3x3 + LeakyReLU."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.conv = Conv2d(dim, dim, 3, **kw)
        self.Transformer = TransformerBlock(dim, num_heads, ffn_expansion, **kw)
        self.channel_reduce = Conv2d(dim * 2, dim, 1, **kw)
        self.Conv_out = Conv2d(dim, dim, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = leaky_relu(self.conv(x), 0.2)
        trans = self.Transformer(x).to(conv.dtype)
        y = self.channel_reduce(torch.cat([conv, trans], dim=1))
        return leaky_relu(self.Conv_out(y), 0.2)


class Downsample(nn.Module):
    """Bias-free 3x3 conv dim -> dim/2, then pixel_unshuffle(2): net 2x
    channels at half resolution."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        self.body = nn.Sequential(Conv2d(dim, dim // 2, 3, bias=False, device=device,
                                         dtype=dtype, compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.pixel_unshuffle(self.body(x), 2)
        return y.contiguous(memory_format=torch.channels_last)


class Upsample2x(nn.ConvTranspose2d):
    """2x upsampling, ``ConvTranspose2d(k=2, s=2)`` computing in
    ``compute_dtype``; bias per output channel."""

    def __init__(self, in_channels: int, out_channels: int, *, device=None,
                 dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__(in_channels, out_channels, 2, stride=2, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd), self.bias.to(cd), stride=2)

"""NHWC convolution primitives.

Port of the single-chip path of
``bayer_low_light_image_enhancement_tpu/ops/conv.py``: NHWC input, HWIO
kernel, torch ``padding=(eff_k-1)//2`` semantics (symmetric zero padding,
also for strided convs), and the global reductions ``global_mean`` /
``global_max``. The halo-exchange paths and cross-device reductions for
spatially sharded execution are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    groups: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """[B, H, W, Cin] x (kh, kw, Cin/groups, Cout) -> [B, H', W', Cout].

    The output dtype is the input's; the kernel and bias are cast to it.
    """
    kh, kw = kernel.shape[0], kernel.shape[1]
    pad = ((dilation * (kh - 1)) // 2, (dilation * (kw - 1)) // 2)
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w, b,
        stride=stride, padding=pad, dilation=dilation, groups=groups,
    )
    return y.permute(0, 2, 3, 1)


def global_mean(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Mean over ``dims``, kept as size-1 dims (x's dtype)."""
    return x.mean(dim=dims, keepdim=True)


def global_max(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """Max over ``dims``, kept as size-1 dims."""
    return x.amax(dim=dims, keepdim=True)

"""Channel LayerNorm for NHWC feature maps.

Port of ``bayer_low_light_image_enhancement_tpu/ops/norm.py``: a last-axis
LayerNorm with torch semantics (biased variance, eps 1e-5), statistics in
fp32 whatever the compute dtype (fp64 for fp64 inputs).
"""

from __future__ import annotations

from typing import Optional

import torch

from bayer_low_light_image_enhancement_tpu_torch.core.precision import wide


def channel_layernorm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    bias_free: bool = False,
) -> torch.Tensor:
    """LayerNorm over the last (channel) axis.

    ``bias_free=True`` is Restormer's BiasFree LayerNorm: divide by
    sqrt(var + eps) without mean-centering.
    """
    xf = wide(x)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    if bias_free:
        y = xf * torch.rsqrt(var + eps)
    else:
        y = (xf - xf.mean(dim=-1, keepdim=True)) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(xf.dtype)
    if bias is not None and not bias_free:
        y = y + bias.to(xf.dtype)
    return y.to(x.dtype)

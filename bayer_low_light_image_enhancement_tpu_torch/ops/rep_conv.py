"""Re-parameterisable conv blocks and the WFB gated FeedForward.

Port of ``bayer_low_light_image_enhancement_tpu/ops/rep_conv.py``:

* ``BatchNorm2d``: BatchNorm with the JAX package's statistics: fp32 (fp64
  for an fp64 input), the batch variance ``E[x^2] - E[x]^2`` (biased,
  clipped at 0) both to normalise and to update ``running_var``, momentum
  0.1 in torch's sense (0.9 in the JAX package's). ``torch.nn.BatchNorm2d``
  would update ``running_var`` with the unbiased variance; the port follows
  the JAX package, not the reference's torch training. Under data
  parallelism (``set_batchnorm_group``) the per-channel sums of x and x^2
  and the count are summed over the data group first, so that every rank
  normalises with, and keeps, the global batch's statistics, as the JAX
  package's mesh does (its ``jit`` sees the whole batch).
* ``Conv2dBN``: bias-free conv + BatchNorm2d (``fuse_conv_bn`` folds them).
* ``GatedFeedForward``: project_in -> x1 = x + rep3x3(x) + rep1x1(x),
  x2 = dw3x3(x), out = gelu(x2) x1 + gelu(x1) x2 (exact GELU in fp32) ->
  project_out, + identity.

Modules are NCHW (held channels_last) with the reference's parameter names.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.core.mesh import sum_over
from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d


class BatchNorm2d(nn.BatchNorm2d):
    """fp32 (fp64 for an fp64 input) BatchNorm with the JAX package's batch
    statistics (see the module doc)."""

    def __init__(self, features: int, *, device=None, dtype=torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device, dtype=dtype)
        self.process_group = None  # the data group whose batch the statistics span

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and self.process_group is not None:
            c = xf.shape[1]
            sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                              xf.new_full((1,), xf.numel() // c)])
            sums = sum_over(sums, self.process_group)
            mean = sums[:c] / sums[2 * c]
            var = (sums[c:2 * c] / sums[2 * c] - mean * mean).clamp_min(0.0)
        elif self.training:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
                self.running_var.mul_(1.0 - m).add_(m * var.detach())
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.to(xf.dtype), self.running_var.to(xf.dtype)
        scale = self.weight.to(xf.dtype) * torch.rsqrt(var + self.eps)
        return (xf - mean[:, None, None]) * scale[:, None, None] + self.bias.to(xf.dtype)[:, None, None]


def set_batchnorm_group(module: nn.Module, group) -> None:
    """Take every BatchNorm2d's batch statistics in ``module`` over the
    data ``group`` (None: over the local batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group


class Conv2dBN(nn.Module):
    """Bias-free conv (``c``) + BatchNorm2d (``bn``); output fp32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 groups: int = 1, *, device=None, dtype=torch.float32,
                 compute_dtype=torch.float32):
        super().__init__()
        self.c = Conv2d(in_channels, out_channels, kernel_size, groups=groups, bias=False,
                        device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.bn = BatchNorm2d(out_channels, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.c(x))


class GatedFeedForward(nn.Module):
    """WFB FeedForward with the structural re-param branches; hidden width
    ``int(dim * ffn_expansion)``."""

    def __init__(self, dim: int, ffn_expansion: float = 2.66, bias: bool = True,
                 *, device=None, dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        hidden = int(dim * ffn_expansion)
        kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.project_in = Conv2d(dim, hidden, 1, bias=bias, **kw)
        self.rep_conv1 = Conv2dBN(hidden, hidden, 3, groups=hidden, **kw)
        self.rep_conv2 = Conv2dBN(hidden, hidden, 1, groups=hidden, **kw)
        self.dwconv = Conv2d(hidden, hidden, 3, groups=hidden, bias=bias, **kw)
        self.project_out = Conv2d(hidden, dim, 1, bias=bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        x = self.project_in(x)
        x1 = x + self.rep_conv1(x) + self.rep_conv2(x)  # fp32, as the JAX promotion
        x2 = self.dwconv(x)
        g1 = F.gelu(x2.float()).to(x2.dtype)
        g2 = F.gelu(x1.float()).to(x1.dtype)
        return self.project_out(g1 * x1 + g2 * x2) + identity


def fuse_conv_bn(conv_weight: torch.Tensor, bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                 bn_mean: torch.Tensor, bn_var: torch.Tensor,
                 eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an eval-mode BatchNorm into the conv before it (OIHW weight):
    -> (fused weight, fused bias)."""
    w = bn_scale / torch.sqrt(bn_var + eps)
    return conv_weight * w[:, None, None, None], bn_bias - bn_mean * w

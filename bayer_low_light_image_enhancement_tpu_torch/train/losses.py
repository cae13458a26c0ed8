"""Training losses.

Port of ``bayer_low_light_image_enhancement_tpu/train/losses.py``:

* Charbonnier (eps 1e-3), the canonical RawFormer loss;
* L1 and MSE;
* the SID color loss of the TrueColor variants: 0.7 MSE + 0.2 L1(Lab) +
  0.1 angular.

Inputs are channels-last ([..., 3] for the color terms). Every loss reduces
in fp32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Callable

import torch

_D65 = (0.95047, 1.0, 1.08883)
# sRGB (linear) -> XYZ, rows X/Y/Z.
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    diff = pred.float() - target.float()
    return torch.mean(torch.sqrt(diff * diff + eps * eps))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.float() - target.float()
    return torch.mean(d * d)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB [..., 3] in [0, 1] -> CIELAB (D65)."""
    rgb = rgb.float().clamp(0.0, 1.0)
    m = torch.tensor(_RGB2XYZ, dtype=torch.float32, device=rgb.device)
    xyz = rgb @ m.T / torch.tensor(_D65, dtype=torch.float32, device=rgb.device)
    eps, kappa = 216.0 / 24389.0, 24389.0 / 27.0
    f = torch.where(xyz > eps, xyz.clamp_min(1e-8) ** (1.0 / 3.0), (kappa * xyz + 16.0) / 116.0)
    fx, fy, fz = f.unbind(-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def angular_color_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean (1 - cos) of the angle between RGB vectors per pixel."""
    p, t = pred.float(), target.float()
    dot = torch.sum(p * t, dim=-1)
    denom = torch.linalg.vector_norm(p, dim=-1) * torch.linalg.vector_norm(t, dim=-1) + eps
    return torch.mean(1.0 - dot / denom)


def sid_color_loss(pred: torch.Tensor, target: torch.Tensor, w_mse: float = 0.7,
                   w_lab: float = 0.2, w_ang: float = 0.1) -> torch.Tensor:
    lab_l1 = torch.mean(torch.abs(rgb_to_lab(pred) - rgb_to_lab(target)))
    return (w_mse * mse_loss(pred, target) + w_lab * lab_l1
            + w_ang * angular_color_loss(pred, target))


_LOSSES = {
    "charbonnier": charbonnier_loss,
    "l1": l1_loss,
    "mse": mse_loss,
    "sid_color": sid_color_loss,
}


def get_loss(name: str) -> Callable:
    try:
        return _LOSSES[name]
    except KeyError:
        raise KeyError(f"unknown loss {name!r}; available: {sorted(_LOSSES)}") from None

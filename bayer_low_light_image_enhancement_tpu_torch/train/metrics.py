"""Image-quality metrics: PSNR and SSIM.

Port of ``bayer_low_light_image_enhancement_tpu/train/metrics.py``, which
reproduces scikit-image's defaults: PSNR at data_range 255 on the uint8
grid; SSIM with a 7x7 uniform window, K1 0.01, K2 0.03, sample (N/(N-1))
covariance, mean over the valid (border-cropped) region and over channels.
Images are channels-last, [H, W, C] or [B, H, W, C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """PSNR over the whole array (skimage peak_signal_noise_ratio)."""
    mse = torch.mean((pred.float() - target.float()) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / mse.clamp_min(1e-12))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode mean over win x win windows of [B, H, W, C] -> NHWC."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), win, stride=1)
    return y.permute(0, 2, 3, 1)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM; [H, W, C] -> scalar, [B, H, W, C] -> [B]."""
    batched = pred.dim() == 4
    p, t = (pred.float(), target.float()) if batched else (pred.float()[None], target.float()[None])
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    ux, uy = _uniform_filter(p, win_size), _uniform_filter(t, win_size)
    uxx, uyy = _uniform_filter(p * p, win_size), _uniform_filter(t * t, win_size)
    uxy = _uniform_filter(p * t, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    s = s.mean(dim=(1, 2, 3))
    return s if batched else s[0]


def _to_uint8_vals(x01: torch.Tensor) -> torch.Tensor:
    # The reference quantises with a truncating cast, (x*255).astype(np.uint8):
    # floor, not round.
    return torch.floor(x01.float().clamp(0.0, 1.0) * 255.0).clamp(0.0, 255.0)


def psnr_uint8(pred01: torch.Tensor, target01: torch.Tensor) -> torch.Tensor:
    """The reference eval protocol: clamp to [0, 1], quantise to uint8, PSNR
    at data_range 255."""
    return psnr(_to_uint8_vals(pred01), _to_uint8_vals(target01), 255.0)


def ssim_uint8(pred01: torch.Tensor, target01: torch.Tensor) -> torch.Tensor:
    return ssim(_to_uint8_vals(pred01), _to_uint8_vals(target01), 255.0)

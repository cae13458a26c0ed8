"""SID uint16 codes -> RawFormer's input, and the frame request around the
reference model.

The SID Sony decode: codes clipped to [512, 16383] (black and white
level), shifted by the black level, scaled by 1 / (16383 - 512 + 1e-6) and
multiplied by the exposure ratio. A served frame is zero-padded in codes to
a multiple of ``pad_to`` (code 0 decodes to 0), run whole, cropped back
and clamped to [0, 1].
"""

import torch
import torch.nn.functional as F

BLACK_LEVEL = 512.0
WHITE_LEVEL = 16383.0


def codes_to_float(codes: torch.Tensor) -> torch.Tensor:
    """uint16 codes (as uint16, or as their int16 bits) -> fp32 0..65535."""
    if codes.dtype in (torch.uint16, torch.int16):
        return (codes.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)
    return codes.to(torch.float32)


def decode_sid(codes: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """[B, H, W] codes + [B] ratios -> [B, 1, H, W] amplified mosaic."""
    x = codes_to_float(codes).clamp(BLACK_LEVEL, WHITE_LEVEL)
    x = (x - BLACK_LEVEL) / (WHITE_LEVEL - BLACK_LEVEL + 1e-6)
    return (x * ratio.to(torch.float32).reshape(-1, 1, 1))[:, None]


@torch.no_grad()
def serve_frame(model, codes: torch.Tensor, ratio: float, pad_to: int) -> torch.Tensor:
    """One [H, W] uint16 mosaic and its ratio -> [H, W, 3] fp32 RGB in
    [0, 1], as a frame service returns it."""
    h, w = codes.shape
    x = codes_to_float(codes)
    x = F.pad(x, (0, (-w) % pad_to, 0, (-h) % pad_to))
    ratio_t = torch.tensor([ratio], dtype=torch.float32, device=x.device)
    y = model(decode_sid(x[None], ratio_t))
    return y[0, :, :h, :w].permute(1, 2, 0).clamp(0.0, 1.0)

"""Synthetic SID Sony captures, made on the run's device from the seed.

The generator of the port's ``data/synthetic.py`` (its constants and its
dark-frame synthesis, copied here so that the benchmark's inputs do not
move with the program): a smooth random RGB scene of four low-frequency
sinusoids, min-max normalised to [0, 1]; mosaicked through an RGGB CFA;
darkened by the exposure ratio; read noise of 0.5 codes; quantised to the
SID Sony uint14 code range above the black level. The ground truth is the
scene in 16-bit codes. Exposure ratios come from SID's {100, 250, 300}.

Each call makes ``n`` images in a few batched device calls and returns
numpy arrays in host memory, where a client holds its requests.
"""

import math

import numpy as np
import torch

BLACK_LEVEL = 512.0
WHITE_LEVEL = 16383.0
SID_RATIOS = (100.0, 250.0, 300.0)
READ_NOISE_CODES = 0.5
COMPONENTS = 4


def _scenes(g: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """[n, h, w, 3] fp32 scenes in [0, 1]."""
    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    fy, fx = u((n, COMPONENTS), 0.5, 4.0), u((n, COMPONENTS), 0.5, 4.0)
    ph = u((n, COMPONENTS, 3), 0.0, 2 * math.pi)
    amp = u((n, COMPONENTS, 3), 0.1, 0.4)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    img = torch.zeros((n, h, w, 3), device=device)
    for c in range(COMPONENTS):
        for i in range(n):
            base = torch.sin(2 * math.pi * (fy[i, c] * yy + fx[i, c] * xx))
            img[i] += amp[i, c] * torch.sin(ph[i, c]) + amp[i, c] * base[..., None]
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return (img - lo) / (hi - lo + 1e-6)


def _mosaic_rggb(rgb: torch.Tensor) -> torch.Tensor:
    m = torch.empty(rgb.shape[:3], device=rgb.device)
    m[:, 0::2, 0::2] = rgb[:, 0::2, 0::2, 0]
    m[:, 0::2, 1::2] = rgb[:, 0::2, 1::2, 1]
    m[:, 1::2, 0::2] = rgb[:, 1::2, 0::2, 1]
    m[:, 1::2, 1::2] = rgb[:, 1::2, 1::2, 2]
    return m


def captures(seed: int, n: int, h: int, w: int, device, with_gt: bool):
    """``n`` dark captures of h x w: (mosaics uint16 [n, h, w], ratios
    float32 [n], and with ``with_gt`` the ground truth uint16 [n, h, w, 3]).
    The same seed gives the same arrays on the same kind of device."""
    g = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    ratios = torch.tensor(SID_RATIOS, device=device)[
        torch.randint(len(SID_RATIOS), (n,), generator=g, device=device)]
    scenes = _scenes(g, n, h, w, device)
    dark = _mosaic_rggb(scenes) / ratios[:, None, None]
    noise = torch.randn(dark.shape, generator=g, device=device) * (READ_NOISE_CODES / WHITE_LEVEL)
    code = dark * (WHITE_LEVEL - BLACK_LEVEL) + BLACK_LEVEL
    code = (code + noise * WHITE_LEVEL).clamp(0.0, WHITE_LEVEL).to(torch.int16)
    out = [code.cpu().numpy().view(np.uint16), ratios.cpu().numpy().astype(np.float32)]
    if with_gt:
        gt = torch.round(scenes * 65535.0).to(torch.int32).cpu().numpy().astype(np.uint16)
        out.append(gt)
    return tuple(out)

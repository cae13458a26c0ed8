"""Band mode: the single-card full-resolution forward of RawFormer S/B/L.

Port of the band half of ``bayer_low_light_image_enhancement_tpu/models/
fused_apply.py`` (its other half has counterparts elsewhere:
``TransformerBlock.forward``'s ``FUSE_CMAX`` / ``spatial`` gate for
``_fusable``, ``set_fused_blocks`` for ``make_fused_forward``,
``FusedTransformerBlockFn`` for ``trainable=True``; the W-packed rewrites of
``ops/wpack.py`` are TPU lane packing and not ported).

``make_banded_forward(model, bands)`` cuts each [B, 1, H, W] frame into
``bands`` H-bands riding the batch axis (a free view: image b is band
b % bands of frame b // bands), runs the model with the band count bound
to its modules (``models.common.bind_bands``) and puts the bands back
together. The result is the monolithic frame's forward: a spatial conv
takes its halo rows from the neighbour bands (``band_halo``), every
TransformerBlock runs band mode (K2 / K3 in band mode on the card at every
width, B's C = 384 and L's C = 512 bottleneck included, as the JAX band
mode fuses every block; their twins on the CPU; the module path with
frame-wide attention sums only with ``set_fused_blocks(model, False)``),
and the 1x1 convs, LayerNorm, pixel_(un)shuffle and the upsamples are
band-local. Inference only, as in the JAX package.

The eval CLI sends a canonical RawFormer frame of H >= 1024 at batch 1 on
the card through it, H padded to a multiple of 128 and cut into
``pick_bands(H)`` bands (``cli/test_cli.band_count``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from bayer_low_light_image_enhancement_tpu_torch.models.common import bind_bands
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import band_halo

__all__ = ["BandedForward", "band_halo", "make_banded_forward", "pick_bands"]

# Rows of the model's /16 grid: one pixel_unshuffle and three downsamples.
BAND_UNIT = 16


def pick_bands(h: int, target: int = 8, unit: int = BAND_UNIT) -> int:
    """Largest band count <= target such that h splits into equal bands
    each divisible by ``unit`` (the model's /16 grid); 1 if none does. The
    eval CLI pads H to a multiple of ``target * unit`` first, so this
    normally returns ``target``."""
    for k in range(target, 0, -1):
        if h % k == 0 and (h // k) % unit == 0:
            return k
    return 1


class BandedForward(nn.Module):
    """``model`` (a RawFormer) as a model of whole frames run in ``bands``
    H-bands: ``forward(x, prepacked=False)`` takes what the model takes
    ([B, 1, H, W] mosaics, or with ``prepacked`` the packed [B, 4, H/2,
    W/2] planes) and returns its [B, 3, H, W]. H must split into ``bands``
    equal bands of a multiple of 16 mosaic rows, else ValueError; with grad
    enabled it raises RuntimeError (an inference path). ``config`` is the
    model's, so that ``Predictor`` serves it as it serves the model."""

    def __init__(self, model: nn.Module, bands: int):
        super().__init__()
        if bands < 1:
            raise ValueError(f"bands must be >= 1, got {bands}")
        self.model, self.bands = model, bands
        self.config = model.config

    def forward(self, x: torch.Tensor, prepacked: bool = False) -> torch.Tensor:
        if torch.is_grad_enabled():
            raise RuntimeError("band streaming is an inference path: call it under "
                               "torch.no_grad() or torch.inference_mode()")
        k = self.bands
        b, c, h, w = x.shape
        unit = BAND_UNIT // 2 if prepacked else BAND_UNIT
        if h % k or (h // k) % unit:
            raise ValueError(f"H = {h} does not split into {k} equal bands of a multiple of "
                             f"{unit} rows")
        xb = x.permute(0, 2, 3, 1).reshape(b * k, h // k, w, c).permute(0, 3, 1, 2)
        bind_bands(self.model, k)
        try:
            y = self.model(xb, prepacked=prepacked)
        finally:
            bind_bands(self.model, 1)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(b, k * y.shape[1], *y.shape[2:]).permute(0, 3, 1, 2)


def make_banded_forward(model: nn.Module, bands: int) -> BandedForward:
    """The banded full-frame forward of ``model`` (RawFormer S/B/L):
    ``make_banded_forward(model, k)(x)`` equals ``model(x)`` on [B, 1, H, W]
    mosaics whose H splits into k equal bands of a multiple of 16 rows.
    Its blocks run K3 whatever their ``apply_kernel`` (the JAX package's
    pipelined kernel needs one band)."""
    return BandedForward(model, bands)

"""Multi-level FLCA RawFormer with colour anchors.

Port of ``bayer_low_light_image_enhancement_tpu/models/multilvl_flca.py``:
the FLCA U-Net with ``FLCAPyramid`` stages, plus two output corrections:

* ``color_anchor_correction``: nudge the per-channel output means toward
  the linear-demosaic input means, strength alpha = 0.12;
* an LL-anchor luminance nudge of strength 0.03 from a 2-level Haar of the
  luma guidance.

And the companion ``color_consistency_loss``. The downsamples are bare
Sequentials (``down{j}.0.weight``), as in the reference.

``MultiLvlFLCAConfig.spatial_axis``: as ``models/flca_rawformer.py``'s;
bound, the colour anchor's two means cross the spatial groups and the LL
anchor's resize is the sharded one of ``ops/flca.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import Conv2d, reset_parameters_
from bayer_low_light_image_enhancement_tpu_torch.models.flca_rawformer import (
    GuidedStage,
    GuidedUNet,
    pack_planes,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import global_mean, leaky_relu
from bayer_low_light_image_enhancement_tpu_torch.ops.dwt import haar_dwt_fb
from bayer_low_light_image_enhancement_tpu_torch.ops.flca import (
    FLCAPyramid,
    nchw,
    nhwc,
    resize_bilinear,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.luma import BT601, bayer_luma_chroma


def demosaic_from_packed(planes: torch.Tensor) -> torch.Tensor:
    """[.., 4] (R, G1, G2, B) -> [.., 3] linear demosaic (NHWC)."""
    g = 0.5 * (planes[..., 1:2] + planes[..., 2:3])
    return torch.cat([planes[..., 0:1], g, planes[..., 3:4]], -1)


def color_anchor_correction(out_rgb: torch.Tensor, packed: torch.Tensor,
                            alpha: float = 0.12, spatial_axis=None) -> torch.Tensor:
    """Mean-shift NHWC ``out_rgb`` toward the linear-demosaic mean of the
    NHWC ``packed`` planes (means are resize-invariant: no upsample), both
    means over the spatial groups of a bound ``spatial_axis``."""
    in_mean = global_mean(demosaic_from_packed(packed), (1, 2), spatial_axis)
    return out_rgb + alpha * (in_mean - global_mean(out_rgb, (1, 2), spatial_axis))


def color_consistency_loss(pred_rgb: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """L2 between the per-channel means of the NHWC prediction and of the
    demosaiced NHWC input."""
    in_mean = demosaic_from_packed(packed).float().mean((1, 2))
    return (in_mean - pred_rgb.float().mean((1, 2))).square().mean()


class PyramidStage(GuidedStage):
    """The multi-level stage: the FLCAPyramid branch."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 flca_levels: int = 2, **kw):
        super().__init__(dim, FLCAPyramid(dim, flca_levels, **kw), num_heads, ffn_expansion,
                         **kw)


class SequentialDownsample(nn.Sequential):
    """Bias-free 3x3 conv dim -> dim/2 then pixel_unshuffle(2), held as a
    bare Sequential; channels_last out."""

    def __init__(self, dim: int, **kw):
        super().__init__(Conv2d(dim, dim // 2, 3, bias=False, **kw), nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).contiguous(memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class MultiLvlFLCAConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 8, 8, 8)
    ffn_expansion: int = 2
    flca_levels: int = 2
    anchor_alpha: float = 0.12
    ll_nudge: float = 0.03
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py).
    spatial_axis: Optional[object] = None


class MultiLvlFLCARawFormer(GuidedUNet):
    state_dict_from_jax = staticmethod(jax_params.multilvl_flca_state_dict_from_jax)

    def __init__(self, config: MultiLvlFLCAConfig = MultiLvlFLCAConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        self.build_unet(
            cfg, lambda d, h: PyramidStage(d, h, cfg.ffn_expansion, cfg.flca_levels, **kw),
            lambda d: SequentialDownsample(d, **kw), kw)
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, sp = self.config, self.spatial
        x_ds = pack_planes(x, cfg.dtype)
        planes = nhwc(x_ds).float()
        y, cr, cb = bayer_luma_chroma(planes, spatial_axis=sp)
        ll_anchor = y
        for _ in range(2):
            ll_anchor, _ = haar_dwt_fb(ll_anchor)

        guide = (nchw(t).to(cfg.dtype) for t in (y, cr, cb))
        out = leaky_relu(self.unet(x_ds, *guide), 0.2)
        out = nhwc(F.pixel_shuffle(out, 2).float())
        out = color_anchor_correction(out, planes, cfg.anchor_alpha, sp)

        ll_up = resize_bilinear(ll_anchor, out.shape[1], out.shape[2], sp)
        wr, wg, wb = BT601
        out_y = wr * out[..., 0:1] + wg * out[..., 1:2] + wb * out[..., 2:3]
        return nchw(out + (ll_up - out_y) * cfg.ll_nudge)


def _build(device=None, generator: Optional[torch.Generator] = None,
           **kw) -> MultiLvlFLCARawFormer:
    return MultiLvlFLCARawFormer(MultiLvlFLCAConfig(**kw), device=device, generator=generator)


register_model("multilvl_flca_rawformer", _build)

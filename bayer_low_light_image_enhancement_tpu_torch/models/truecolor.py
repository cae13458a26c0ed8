"""TrueColorRawFormer: the learned-ISP guided U-Net.

Port of ``bayer_low_light_image_enhancement_tpu/models/truecolor.py``: the
canonical TrueColor model and, with ``bayertorgb=True``, the BayerTORGB
variant (softplus-positive gains, residual demosaic refine, bounded tone
curve, pyramid FLCA, log-temperature attention). A ``BayerProcessor``
computes (y, cr, cb, rgb_guide) once from the packed planes; the stages are
FLCA-style dual branches whose guidance adds the rgb guide. Output head:
ReLU (not leaky) -> pixel_shuffle -> ``ColorCorrection``.

Contract: as ``models/flca_rawformer.py`` (fp32 [B, 3, H, W] out, already
in [0, 1] by the colour correction's clip). ``TrueColorConfig.spatial_axis``
as there: bound, ``BayerProcessor`` and ``EnhancedFLCA`` take their sharded
forms (``ops/isp.py``); the colour correction is pointwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bayer_low_light_image_enhancement_tpu_torch.compat import jax_params
from bayer_low_light_image_enhancement_tpu_torch.models.common import (
    Downsample,
    reset_parameters_,
)
from bayer_low_light_image_enhancement_tpu_torch.models.flca_rawformer import (
    GuidedStage,
    GuidedUNet,
    pack_planes,
)
from bayer_low_light_image_enhancement_tpu_torch.models.registry import register_model
from bayer_low_light_image_enhancement_tpu_torch.ops.isp import (
    BayerProcessor,
    ColorCorrection,
    EnhancedFLCA,
)


class TrueColorStage(GuidedStage):
    """The TrueColor stage: the EnhancedFLCA branch (``flca_levels`` > 1
    and ``log_temperature`` in the BayerTORGB variant)."""

    def __init__(self, dim: int, num_heads: int = 8, ffn_expansion: int = 2,
                 flca_levels: int = 1, log_temperature: bool = False, **kw):
        super().__init__(dim, EnhancedFLCA(dim, flca_levels, **kw), num_heads, ffn_expansion,
                         log_temperature, **kw)


@dataclasses.dataclass(frozen=True)
class TrueColorConfig:
    inp_channels: int = 1
    out_channels: int = 3
    dim: int = 48
    num_heads: Tuple[int, int, int, int] = (8, 8, 8, 8)
    ffn_expansion: int = 2
    bayertorgb: bool = False  # the BayerTORGB variant's switches
    dtype: torch.dtype = torch.float32        # compute
    param_dtype: torch.dtype = torch.float32  # storage
    # Mesh axes of spatially sharded inference (parallel/tiled.py).
    spatial_axis: Optional[object] = None


class TrueColorRawFormer(GuidedUNet):
    state_dict_from_jax = staticmethod(jax_params.truecolor_state_dict_from_jax)

    def __init__(self, config: TrueColorConfig = TrueColorConfig(), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=device, dtype=cfg.param_dtype, compute_dtype=cfg.dtype)
        levels = 2 if cfg.bayertorgb else 1
        self.bayer_processor = BayerProcessor(cfg.bayertorgb, **kw)
        self.build_unet(
            cfg, lambda d, h: TrueColorStage(d, h, cfg.ffn_expansion, levels, cfg.bayertorgb,
                                             **kw),
            lambda d: Downsample(d, **kw), kw)
        self.color_correction = ColorCorrection(cfg.out_channels, cfg.bayertorgb, **kw)
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_ds = pack_planes(x, self.config.dtype)
        out = F.relu(self.unet(x_ds, *self.bayer_processor(x_ds)))
        return self.color_correction(F.pixel_shuffle(out, 2)).float()


def _builder(bayertorgb: bool):
    def build(device=None, generator: Optional[torch.Generator] = None,
              **kw) -> TrueColorRawFormer:
        return TrueColorRawFormer(TrueColorConfig(bayertorgb=bayertorgb, **kw), device=device,
                                  generator=generator)

    return build


register_model("truecolor_rawformer", _builder(False))
register_model("bayertorgb_rawformer", _builder(True))

"""Model registry: each model family registers a named builder.

Port of ``bayer_low_light_image_enhancement_tpu/models/registry.py``; the
port registers the JAX registry's 14 models: the RAW -> RGB
``rawformer_s|b|l``, ``rawformer_wfb``, ``flca_rawformer``,
``multilvl_flca_rawformer``, ``truecolor_rawformer``,
``bayertorgb_rawformer``, ``luma_mhsa_rawformer`` and ``wavkan_rawformer``,
and the raw-domain ``flca_unet``, ``unet_luma_dwt``, ``simple_flca_unet``
and ``lumachroma_transformer``.

``get_model(name, spatial_axis=...)`` builds a model for spatially sharded
inference (``parallel/tiled.py``): RawFormer S/B/L (H, or H and W) and
RawFormer-WFB (H). Every other family raises TypeError, which the eval
CLI turns into its "does not support" exit, as the JAX CLI does.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}
_RAW_DOMAIN: set = set()
_SPATIAL: set = set()


def register_model(name: str, builder: Callable, raw_domain: bool = False,
                   spatial: bool = False) -> None:
    """``raw_domain=True`` marks models that map packed Bayer planes to
    enhanced planes ([B,H,W,4] -> [B,H,W,4]) rather than RAW -> RGB; the
    train and eval CLIs refuse them. ``spatial=True`` marks a builder that
    takes ``spatial_axis``."""
    if name in _REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _REGISTRY[name] = builder
    if raw_domain:
        _RAW_DOMAIN.add(name)
    if spatial:
        _SPATIAL.add(name)


def is_raw_domain(name: str) -> bool:
    return name in _RAW_DOMAIN


def get_model(name: str, **kwargs):
    """Build a registered model by name, e.g. ``get_model('rawformer_s')``."""
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    if "spatial_axis" in kwargs and name not in _SPATIAL:
        raise TypeError(f"model {name!r} takes no spatial_axis: its spatially sharded "
                        f"inference is not ported yet (ported: {sorted(_SPATIAL)})")
    return builder(**kwargs)


def list_models() -> List[str]:
    return sorted(_REGISTRY)

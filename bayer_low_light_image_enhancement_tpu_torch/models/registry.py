"""Model registry: each model family registers a named builder.

Port of ``bayer_low_light_image_enhancement_tpu/models/registry.py``; the
port registers the JAX registry's 14 models: the RAW -> RGB
``rawformer_s|b|l``, ``rawformer_wfb``, ``flca_rawformer``,
``multilvl_flca_rawformer``, ``truecolor_rawformer``,
``bayertorgb_rawformer``, ``luma_mhsa_rawformer`` and ``wavkan_rawformer``,
and the raw-domain ``flca_unet``, ``unet_luma_dwt``, ``simple_flca_unet``
and ``lumachroma_transformer``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}
_RAW_DOMAIN: set = set()


def register_model(name: str, builder: Callable, raw_domain: bool = False) -> None:
    """``raw_domain=True`` marks models that map packed Bayer planes to
    enhanced planes ([B,H,W,4] -> [B,H,W,4]) rather than RAW -> RGB; the
    train and eval CLIs refuse them."""
    if name in _REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _REGISTRY[name] = builder
    if raw_domain:
        _RAW_DOMAIN.add(name)


def is_raw_domain(name: str) -> bool:
    return name in _RAW_DOMAIN


def get_model(name: str, **kwargs):
    """Build a registered model by name, e.g. ``get_model('rawformer_s')``."""
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return builder(**kwargs)


def list_models() -> List[str]:
    return sorted(_REGISTRY)

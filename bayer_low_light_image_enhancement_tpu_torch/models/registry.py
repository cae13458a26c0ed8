"""Model registry: each model family registers a named builder.

Port of ``bayer_low_light_image_enhancement_tpu/models/registry.py``; the
port registers ``rawformer_s|b|l`` and ``rawformer_wfb`` so far.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str, builder: Callable) -> None:
    if name in _REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _REGISTRY[name] = builder


def get_model(name: str, **kwargs):
    """Build a registered model by name, e.g. ``get_model('rawformer_s')``."""
    try:
        builder = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}") from None
    return builder(**kwargs)


def list_models() -> List[str]:
    return sorted(_REGISTRY)

from bayer_low_light_image_enhancement_tpu_torch.models.registry import (
    get_model,
    list_models,
    register_model,
)
from bayer_low_light_image_enhancement_tpu_torch.models.rawformer import (
    SIZE_DIMS,
    RawFormer,
    RawFormerConfig,
)
from bayer_low_light_image_enhancement_tpu_torch.models.wfb import (
    RawFormerWFB,
    RawFormerWFBConfig,
)

__all__ = [
    "get_model",
    "list_models",
    "register_model",
    "RawFormer",
    "RawFormerConfig",
    "RawFormerWFB",
    "RawFormerWFBConfig",
    "SIZE_DIMS",
]

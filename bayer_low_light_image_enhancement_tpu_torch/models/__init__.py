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

# Import the model families for their registry side effects.
from bayer_low_light_image_enhancement_tpu_torch.models import (  # noqa: F401
    flca_rawformer as _flca,
)
from bayer_low_light_image_enhancement_tpu_torch.models import (  # noqa: F401
    multilvl_flca as _multilvl,
)
from bayer_low_light_image_enhancement_tpu_torch.models import truecolor as _truecolor  # noqa: F401
from bayer_low_light_image_enhancement_tpu_torch.models import (  # noqa: F401
    luma_variants as _luma_variants,
)
from bayer_low_light_image_enhancement_tpu_torch.models import wavkan as _wavkan  # noqa: F401
from bayer_low_light_image_enhancement_tpu_torch.models import (  # noqa: F401
    flca_unet as _flca_unet,
)
from bayer_low_light_image_enhancement_tpu_torch.models import (  # noqa: F401
    lumachroma_transformer as _lumachroma,
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

from bayer_low_light_image_enhancement_tpu_torch.ops.shuffle import (
    space_to_depth,
    depth_to_space,
)
from bayer_low_light_image_enhancement_tpu_torch.ops.conv import conv2d, leaky_relu
from bayer_low_light_image_enhancement_tpu_torch.ops.norm import channel_layernorm
from bayer_low_light_image_enhancement_tpu_torch.ops.attention import channel_attention
from bayer_low_light_image_enhancement_tpu_torch.ops.bayer import (
    CFA_PATTERNS,
    normalize_mcr,
    normalize_sid,
    pack_bayer,
)

__all__ = [
    "space_to_depth",
    "depth_to_space",
    "conv2d",
    "leaky_relu",
    "channel_layernorm",
    "channel_attention",
    "CFA_PATTERNS",
    "normalize_mcr",
    "normalize_sid",
    "pack_bayer",
]

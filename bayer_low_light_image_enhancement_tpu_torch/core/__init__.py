from bayer_low_light_image_enhancement_tpu_torch.core.precision import Policy, default_policy

__all__ = ["Policy", "default_policy"]

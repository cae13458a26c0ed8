"""Inference: the Predictor API."""

from bayer_low_light_image_enhancement_tpu_torch.serving.predictor import Predictor

__all__ = ["Predictor"]

"""Inference: the Predictor API and self-contained serving artifacts.

* ``predictor.Predictor``: frames, uint16 mosaics or sensor codes through a
  model and its weights;
* ``export.export_artifact`` / ``load_artifact``: the forward traced by
  ``torch.export`` into one file that serves without the model's code
  (``cli/export_cli.py`` writes one from a checkpoint).
"""

from bayer_low_light_image_enhancement_tpu_torch.serving.export import (
    export_artifact,
    load_artifact,
)
from bayer_low_light_image_enhancement_tpu_torch.serving.predictor import Predictor

__all__ = ["Predictor", "export_artifact", "load_artifact"]

"""PyTorch + CUDA port of ``bayer_low_light_image_enhancement_tpu``.

RawFormer inference on an NVIDIA H100: the same module layout as the JAX
package (``ops/``, ``kernels/``, ``models/``, ``serving/``, ``compat/``),
NCHW modules held in ``torch.channels_last``, NHWC at the ``ops``/``kernels``
signatures, and hand-written CUDA kernels for sm_90a under ``csrc/`` where
the JAX package has Pallas TPU kernels. The port imports torch and numpy
only, never jax.
"""

__version__ = "0.1.0"

from bayer_low_light_image_enhancement_tpu_torch.core.precision import Policy, default_policy
from bayer_low_light_image_enhancement_tpu_torch.models import get_model, list_models

__all__ = ["Policy", "default_policy", "get_model", "list_models", "__version__"]

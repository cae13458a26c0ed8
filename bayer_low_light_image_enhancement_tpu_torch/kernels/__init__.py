"""Hand-written CUDA kernels (``csrc/``) behind PyTorch wrappers.

Each wrapper runs its plain PyTorch twin on a CPU tensor and launches its
kernel on a CUDA tensor (or raises). The kernels are built with nvcc at the
first launch (``_build.py``), never at import. Importing this package
registers the forward kernels (K2, K3, K3P, S1, and K2 / K3 in band mode)
as ``torch.ops.blle`` operators (``ops.py``), through which their wrappers
dispatch.
"""

from bayer_low_light_image_enhancement_tpu_torch.kernels import ops  # noqa: F401

"""Hand-written CUDA kernels (``csrc/``) behind PyTorch wrappers.

Each wrapper runs its plain PyTorch twin on a CPU tensor and launches its
kernel on a CUDA tensor (or raises). The kernels are built with nvcc at the
first launch (``_build.py``), never at import.
"""

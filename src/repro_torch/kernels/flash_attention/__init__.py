"""Grouped-query flash attention (forward kernel, recompute backward).

``ops`` holds the public entry point; ``ref.py`` is the plain PyTorch
version the CUDA kernel (``kernel.py``, ``csrc/flash_attention.cu``) is
held to within the working type's tolerance, and the path CPU tensors
take.
"""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401

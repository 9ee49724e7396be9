"""3x3 max / argmax / min pooling (paper Algorithm 1 lines 1 and 6).

``ops`` holds the public entry points; ``ref.py`` is the plain PyTorch
version the CUDA kernel (``kernel.py``, ``csrc/maxpool.cu``) must match
bitwise, and the path CPU tensors take.
"""
from repro_torch.kernels.maxpool.ops import (  # noqa: F401
    maxargmaxpool3x3,
    maxpool3x3,
    minpool3x3,
)

"""Fused PixHomology phase-A kernel (pointers + in-strip snap + flags).

``ops.fused_phase_a`` is the public entry point; ``ref.py`` is the plain
PyTorch version the CUDA kernel (``kernel.py``, ``csrc/phase_a.cu``) must
match bitwise, and the path CPU tensors take.
"""
from repro_torch.kernels.ph_phase_a.ops import (  # noqa: F401
    boundary_rows,
    fused_phase_a,
)

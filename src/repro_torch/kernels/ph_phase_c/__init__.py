"""Fused PixHomology phase-C kernel (per-cluster best-edge reduction).

``ops.best_edge_reduce`` dispatches the Boruvka round's reduction between
the CUDA kernel (``kernel.py``, ``csrc/best_edge.cu``) and the plain
PyTorch version (``ref.py``); ``ops.fused_merge`` is the whole-image
fused phase C over the compact root instance.
"""
from repro_torch.kernels.ph_phase_c.ops import (  # noqa: F401
    best_edge_reduce,
    fused_merge,
)

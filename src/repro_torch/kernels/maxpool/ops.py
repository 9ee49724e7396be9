"""Public 3x3 pooling entry points, dispatched by tensor device.

A CUDA tensor runs the hand-written kernel (``kernel.py``) unless the
caller passes ``use_pallas=False``, which selects the plain version
explicitly (what the on-card comparison runs).  A CPU tensor runs the
plain version (``ref.py``).  There is no fallback from the kernel to the
plain version: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.maxpool import kernel, ref


def _on_kernel(x: torch.Tensor, use_pallas: bool | None) -> bool:
    return x.is_cuda and use_pallas is not False


def maxargmaxpool3x3(x: torch.Tensor, *, use_pallas: bool | None = None):
    """Fused 3x3 (maxpool, argmaxpool), stride 1, pad 1: ``(max: x.dtype,
    argmax: int32 flat index)``, both of ``x``'s shape."""
    if _on_kernel(x, use_pallas):
        return kernel.maxargmaxpool3x3(x)
    return ref.maxargmaxpool3x3(x)


def maxpool3x3(x: torch.Tensor, *, use_pallas: bool | None = None):
    if _on_kernel(x, use_pallas):
        return kernel.maxpool3x3(x)
    return ref.maxpool3x3(x)


def minpool3x3(x: torch.Tensor, *, use_pallas: bool | None = None):
    if _on_kernel(x, use_pallas):
        return kernel.minpool3x3(x)
    return ref.minpool3x3(x)

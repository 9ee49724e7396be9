"""ctypes binding of the hand-written 3x3 pooling CUDA kernel
(``csrc/maxpool.cu``).

The kernel builds with ``nvcc`` at first use (``repro_torch.kernels._build``)
and launches on PyTorch's current stream.  The wrapper checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
and counts its launches in ``LIBRARY.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int

LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "maxpool.cu",
    {"maxpool_launch": [_I, _I, _P, _I, _I, _I, _P, _P, _P]},
    error_fn="maxpool_error_string")

DTYPE_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2,
               torch.float32: 3, torch.bfloat16: 4}
_MAXARG, _MAX, _MIN = 0, 1, 2


def _pool(x: torch.Tensor, mode: int):
    if not x.is_cuda:
        raise ValueError("maxpool kernel needs a CUDA tensor; the plain "
                         "version (ref.py) serves CPU tensors")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"maxpool kernel supports {list(DTYPE_CODES)}, "
                        f"got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"expected (..., H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("maxpool kernel needs a contiguous tensor")
    h, w = x.shape[-2:]
    if h * w >= 2 ** 31:
        raise ValueError(f"image of {h * w} pixels exceeds int32 indices")
    b = x.numel() // (h * w) if h * w else 0
    val = torch.empty_like(x)
    arg = torch.empty(x.shape if mode == _MAXARG else (0,),
                      dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        LIBRARY.call("maxpool_launch", DTYPE_CODES[x.dtype], mode,
                     x.data_ptr(), b, h, w, val.data_ptr(), arg.data_ptr(),
                     stream)
    LIBRARY.launches += 1
    return val, arg


def maxargmaxpool3x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused 3x3 (maxpool, argmaxpool) on the card, bitwise equal to
    ``ref.maxargmaxpool3x3``; ``x`` is (..., H, W)."""
    return _pool(x, _MAXARG)


def maxpool3x3(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, _MAX)[0]


def minpool3x3(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, _MIN)[0]

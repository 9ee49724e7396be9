"""ctypes binding of the hand-written best-edge CUDA kernel
(``csrc/best_edge.cu``).

The kernel builds with ``nvcc`` at first use and launches on PyTorch's
current stream.  The wrapper checks device, dtype, shape and contiguity,
allocates ``best``/``win`` with ``torch.empty`` (the kernel initializes
them), and counts its launches in ``LIBRARY.launches`` — one per call,
i.e. one per Boruvka round on the main path.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int

LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "best_edge.cu",
    {"best_edge_launch": [_I, _P, _P, _P, ctypes.c_longlong, _P, _P, _I,
                          _P]},
    error_fn="best_edge_error_string")

KEY_BITS = {torch.int32: 32, torch.int64: 64}


def best_edge_reduce(key: torch.Tensor, ra: torch.Tensor, rb: torch.Tensor,
                     nv: int):
    """Per-cluster best incident edge on the card, bitwise equal to
    ``ref.best_edge_reduce``.  ``ra``/``rb`` must lie in ``[0, nv)`` on
    every lane (the Boruvka callers guarantee it; it is not re-checked on
    the device, which would cost a readback per round)."""
    if not (key.is_cuda and ra.device == key.device
            and rb.device == key.device):
        raise ValueError("best_edge_reduce kernel needs CUDA tensors on one "
                         "device; the plain version serves CPU tensors")
    if key.dtype not in KEY_BITS:
        raise TypeError(f"keys must be int32 or int64, got {key.dtype}")
    if ra.dtype != torch.int32 or rb.dtype != torch.int32:
        raise TypeError("endpoints must be int32")
    if not (key.dim() == ra.dim() == rb.dim() == 1
            and key.shape == ra.shape == rb.shape):
        raise ValueError(f"key/ra/rb must be 1-D of one length, got "
                         f"{key.shape}, {ra.shape}, {rb.shape}")
    if not (key.is_contiguous() and ra.is_contiguous()
            and rb.is_contiguous()):
        raise ValueError("best_edge_reduce kernel needs contiguous inputs")
    if key.shape[0] >= 2 ** 31:
        raise ValueError("edge count exceeds int32 edge indices")
    best = torch.empty(nv, dtype=key.dtype, device=key.device)
    win = torch.empty(nv, dtype=torch.int32, device=key.device)
    stream = torch.cuda.current_stream(key.device).cuda_stream
    with torch.cuda.device(key.device):
        LIBRARY.call("best_edge_launch", KEY_BITS[key.dtype], key.data_ptr(),
                     ra.data_ptr(), rb.data_ptr(), key.shape[0],
                     best.data_ptr(), win.data_ptr(), nv, stream)
    LIBRARY.launches += 1
    return best, win

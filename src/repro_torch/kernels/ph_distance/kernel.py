"""ctypes binding of the hand-written diagram-distance CUDA kernel
(``csrc/distance.cu``).

The kernel builds with ``nvcc`` at first use and launches on PyTorch's
current stream.  The wrapper checks device, dtype, shape and contiguity,
allocates the outputs and the scratch (sorted rows, per-direction sums)
with ``torch.empty``, and counts its launches in ``LIBRARY.launches`` —
one per call, however many CUDA launches the call makes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int

LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "distance.cu",
    {"distance_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]},
    error_fn="distance_error_string")


def sort_width(f: int) -> int:
    """Row width of the sort scratch: the next power of two >= ``f``."""
    return 1 << max(0, int(f) - 1).bit_length()


def distance_matrix(pts: torch.Tensor, diag: torch.Tensor,
                    prof: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sw, bn)`` (B, B) float32 on the card: ``bn`` bitwise equal to
    ``ref.distance_matrix``, ``sw`` within rtol 1e-5 (reassociated sums),
    exactly symmetric with an exactly zero diagonal."""
    tensors = (pts, diag, prof)
    if not all(t.is_cuda and t.device == pts.device for t in tensors):
        raise ValueError("distance kernel needs CUDA tensors on one device; "
                         "the plain version serves CPU tensors")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"distance kernel needs float32 tables, got "
                        f"{[t.dtype for t in tensors]}")
    if pts.dim() != 3 or diag.shape != pts.shape or prof.dim() != 2 \
            or prof.shape != (pts.shape[0], pts.shape[2]):
        raise ValueError(f"expected pts/diag (B, K, F) and prof (B, F), got "
                         f"{tuple(pts.shape)}, {tuple(diag.shape)}, "
                         f"{tuple(prof.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("distance kernel needs contiguous tables")
    b, k, f = pts.shape
    if f == 0 or k == 0:
        raise ValueError("distance kernel needs F >= 1 and K >= 1")
    p = sort_width(f)
    if 2 * b * k * p >= 2 ** 62 or 2 * f >= 2 ** 31:
        raise ValueError(f"tables of shape {tuple(pts.shape)} exceed the "
                         f"kernel's index range")
    opts = dict(dtype=torch.float32, device=pts.device)
    rows = torch.empty(2 * b * k * p, **opts)
    w1 = torch.empty(b * b * k, **opts)
    sw = torch.empty((b, b), **opts)
    bn = torch.empty((b, b), **opts)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    with torch.cuda.device(pts.device):
        LIBRARY.call("distance_launch", pts.data_ptr(), diag.data_ptr(),
                     prof.data_ptr(), b, k, f, p, rows.data_ptr(),
                     w1.data_ptr(), sw.data_ptr(), bn.data_ptr(), stream)
    LIBRARY.launches += 1
    return sw, bn

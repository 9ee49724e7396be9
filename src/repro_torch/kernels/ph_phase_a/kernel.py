"""ctypes binding of the hand-written phase-A CUDA kernel (``csrc/phase_a.cu``).

The kernel builds with ``nvcc`` at first use (``repro_torch.kernels._build``)
and launches on PyTorch's current stream, one launch per call.  The
wrapper checks device, dtype, shape and contiguity, allocates the two
outputs (no scratch) with ``torch.empty``, and counts its launches in
``LIBRARY.launches``.  ``strip_layout`` mirrors the kernel's choice of
width regime (``csrc/phase_a.cu`` header).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int

LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "phase_a.cu",
    {"phase_a_launch": [_I, _P, _I, _I, _I, _I, _P, _P, _P]},
    error_fn="phase_a_error_string")

DTYPE_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2,
               torch.float32: 3, torch.bfloat16: 4}

# The kernel's constants (csrc/phase_a.cu): shared memory a block may use on
# sm_90, the largest strip with 16-bit pointers, the largest cluster, and
# the shared memory kept for the wide kernel's static array (the cluster's
# vote).
SMEM_BYTES = 232_448
NARROW_ENTRIES = 65_536
MAX_CLUSTER = 8
STATIC_BYTES = 1024


def strip_layout(strip_rows: int, w: int) -> tuple[str, int]:
    """The kernel's width regime for strips of ``strip_rows`` (already
    clamped to the height) rows of ``w`` columns: ``("shared16", 1)``,
    ``("cluster", C)`` (32-bit pointers over C blocks' shared memory) or
    ``("global", 1)`` (32-bit pointers in the output buffer)."""
    if strip_rows * w <= NARROW_ENTRIES:
        return "shared16", 1
    for c in range(2, min(MAX_CLUSTER, strip_rows) + 1):
        if -(-strip_rows // c) * w * 4 + STATIC_BYTES <= SMEM_BYTES:
            return "cluster", c
    return "global", 1


def phase_a(image: torch.Tensor, *, strip_rows: int = 8):
    """Fused phase A on the card: ``(ptr, hi_mask)`` flat int32, bitwise
    equal to ``ref.phase_a``.  ``image`` is (H, W) or a (B, H, W) batch
    (one launch for the whole batch)."""
    if not image.is_cuda:
        raise ValueError("phase_a kernel needs a CUDA tensor; the plain "
                         "version (ref.phase_a) serves CPU tensors")
    if image.dtype not in DTYPE_CODES:
        raise TypeError(f"phase_a kernel supports {list(DTYPE_CODES)}, "
                        f"got {image.dtype}")
    if image.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {image.shape}")
    if not image.is_contiguous():
        raise ValueError("phase_a kernel needs a contiguous image")
    h, w = image.shape[-2:]
    b = 1 if image.dim() == 2 else image.shape[0]
    if h * w >= 2 ** 31:
        raise ValueError(f"image of {h * w} pixels exceeds int32 indices")
    if b > 65_535:
        raise ValueError(f"batch of {b} exceeds the grid's 65,535 rows")
    s = max(1, min(strip_rows, h))
    opts = dict(dtype=torch.int32, device=image.device)
    ptr = torch.empty((b, h * w), **opts)
    mask = torch.empty((b, h * w), **opts)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    with torch.cuda.device(image.device):
        LIBRARY.call("phase_a_launch", DTYPE_CODES[image.dtype],
                     image.data_ptr(), b, h, w, s, ptr.data_ptr(),
                     mask.data_ptr(), stream)
    LIBRARY.launches += 1
    out_shape = (h * w,) if image.dim() == 2 else (b, h * w)
    return ptr.reshape(out_shape), mask.reshape(out_shape)

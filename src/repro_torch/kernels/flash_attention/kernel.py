"""ctypes binding of the hand-written flash attention CUDA kernel
(``csrc/flash_attention.cu``).

The kernel builds with ``nvcc`` at first use (``repro_torch.kernels._build``)
and launches on PyTorch's current stream.  The wrapper checks device,
dtypes, shapes and the contiguous head dim, passes every tensor by pointer
and strides (so transposed views need no copy; a bfloat16 tensor that TMA
cannot address, see ``tma_addressable``, is copied first), allocates the
output with ``torch.empty`` and counts its launches in
``LIBRARY.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int

LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "flash_attention.cu",
    {"flash_attention_fwd_launch": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, ctypes.c_float,
                                    _P]},
    error_fn="flash_attention_error_string")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention kernel needs CUDA tensors; the "
                         "plain version (ref.py) serves CPU tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention kernel takes one of "
                        f"{list(DTYPE_CODES)} for q, k and v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, Sq, hd) and k, v (B, KV, Skv, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not group q "
                         f"{tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if max(q.shape[2], k.shape[2]) >= 2 ** 31 or b >= 65536 or h >= 65536:
        raise ValueError("shape exceeds the kernel's grid and index range")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention kernel needs {name}'s head "
                             f"dim contiguous, got strides {t.stride()}")


def tma_addressable(t: torch.Tensor) -> bool:
    """Whether the bfloat16 path's TMA loads can read ``t`` in place: a
    16-byte aligned base and, on each dim that is stepped (extent > 1),
    a positive stride of a multiple of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (s > 0 and s % 8 == 0)
        for n, s in zip(t.shape[:3], t.stride()[:3]))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Flash attention forward on the card.  q: (B, H, Sq, hd); k, v:
    (B, KV, Skv, hd); query row ``i`` sits at position ``i + q_offset``
    (a block of a longer query sequence), the keys at 0 .. Skv - 1.
    Returns (B, H, Sq, hd), a view of a (B, Sq, H, hd) tensor, so the
    model's head merge is free."""
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if tma_addressable(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not 0 <= q_offset < 2 ** 31 - sq:
        raise ValueError(f"q_offset must be in [0, 2**31 - Sq), got "
                         f"{q_offset}")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        LIBRARY.call("flash_attention_fwd_launch", DTYPE_CODES[q.dtype], hd,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     strides, b, h, kvh, sq, skv, int(causal),
                     0 if window is None else int(window), int(q_offset),
                     hd ** -0.5, stream)
    LIBRARY.launches += 1
    return out

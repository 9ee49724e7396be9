"""ctypes binding of the hand-written diagram-distance CUDA kernel
(``csrc/distance.cu``).

The kernel builds with ``nvcc`` at first use and launches on PyTorch's
current stream.  The wrapper checks device, dtype, shape and contiguity,
allocates the outputs and the scratch (sorted rows, the wide path's
ping-pong rows, merge splits, per-tile partial sums) with ``torch.empty``,
and counts its launches in ``LIBRARY.launches`` — one per call, however
many CUDA launches the call makes.  The constants and the two layout
functions below mirror the source's (``sort_width``, ``merge_tiles``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LIBRARY = CudaLibrary(
    Path(__file__).parent / "csrc" / "distance.cu",
    {"distance_launch": [_P, _P, _P, _I, _I, _I, _L, _P, _P, _P, _P, _P,
                         _P, _P],
     "distance_sort_launch": [_P, _P, _I, _I, _I, _L, _P, _P, _P],
     "distance_pairs_launch": [_P, _P, _I, _I, _I, _L, _P, _P, _P, _P,
                               _P]},
    error_fn="distance_error_string")

CLUSTER_SLOTS = 65536        # the widest row one cluster sorts (4 x 16,384)
MERGE_TILE = 7680            # merged outputs per block of the pair stage
BN_CHUNKS = 32               # column chunks per pair of the bn maxima


def sort_width(f: int) -> int:
    """Row stride of the sort scratch: ``f``, or for rows wider than one
    cluster the wide path's power-of-two count of 65,536-slot tiles."""
    if f <= CLUSTER_SLOTS:
        return f
    tiles = 1
    while tiles * CLUSTER_SLOTS < f:
        tiles *= 2
    return tiles * CLUSTER_SLOTS


def merge_tiles(f: int) -> int:
    """Tiles of ``MERGE_TILE`` merged outputs over the 2F-vector."""
    return -(-2 * f // MERGE_TILE)


def _checked(pts, diag, prof):
    """Validate the tables; returns ``(b, k, f, p)``."""
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
    if p > 2 ** 27 or k >= 2 ** 16 or b * b * k >= 2 ** 31 \
            or 8 * b * k * max(1, p // CLUSTER_SLOTS) >= 2 ** 31:
        raise ValueError(f"tables of shape {tuple(pts.shape)} exceed the "
                         f"kernel's index range")
    return b, k, f, p


def _scratch(b, k, f, p, device):
    """``(rows, tmp, splits, part, sw, bn)``: sorted rows (4 floats of
    slack: the pair stage's 16-byte loads may pass a row's end), the wide
    path's second row buffer (None for rows one cluster holds), the merge
    splits at every tile edge, per-tile double sums followed by the bn
    chunk maxima (float32, two to a float64 slot), the outputs."""
    opts = dict(dtype=torch.float32, device=device)
    rows = torch.empty(2 * b * k * p + 4, **opts)
    tmp = torch.empty(2 * b * k * p + 4, **opts) \
        if f > CLUSTER_SLOTS else None
    pairs, t = b * (b - 1) // 2, merge_tiles(f)
    splits = torch.empty(max(1, pairs * k * 2 * (t + 1)), dtype=torch.int32,
                         device=device)
    part = torch.empty(pairs * k * t + pairs * BN_CHUNKS // 2 + 1,
                       dtype=torch.float64, device=device)
    return rows, tmp, splits, part, torch.empty((b, b), **opts), \
        torch.empty((b, b), **opts)


def _ptr(t):
    return None if t is None else t.data_ptr()


def stages(pts: torch.Tensor, diag: torch.Tensor, prof: torch.Tensor):
    """The kernel's two stages as separate calls on shared scratch, for
    timing each on its own: ``(sort, pairs)``.  ``sort()`` sorts the rows
    into the scratch; ``pairs()`` reduces the pair grid from them and
    returns ``(sw, bn)``.  Each call counts one launch."""
    b, k, f, p = _checked(pts, diag, prof)
    rows, tmp, splits, part, sw, bn = _scratch(b, k, f, p, pts.device)

    def call(name, *args):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        with torch.cuda.device(pts.device):
            LIBRARY.call(name, *args, stream)
        LIBRARY.launches += 1

    def sort():
        call("distance_sort_launch", pts.data_ptr(), diag.data_ptr(), b, k,
             f, p, rows.data_ptr(), _ptr(tmp))

    def pairs():
        call("distance_pairs_launch", rows.data_ptr(), prof.data_ptr(), b, k,
             f, p, splits.data_ptr(), part.data_ptr(), sw.data_ptr(),
             bn.data_ptr())
        return sw, bn

    return sort, pairs


def distance_matrix(pts: torch.Tensor, diag: torch.Tensor,
                    prof: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sw, bn)`` (B, B) float32 on the card: ``bn`` bitwise equal to
    ``ref.distance_matrix``, ``sw`` within rtol 1e-5 (reassociated sums),
    exactly symmetric with an exactly zero diagonal."""
    b, k, f, p = _checked(pts, diag, prof)
    rows, tmp, splits, part, sw, bn = _scratch(b, k, f, p, pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    with torch.cuda.device(pts.device):
        LIBRARY.call("distance_launch", pts.data_ptr(), diag.data_ptr(),
                     prof.data_ptr(), b, k, f, p, rows.data_ptr(), _ptr(tmp),
                     splits.data_ptr(), part.data_ptr(), sw.data_ptr(),
                     bn.data_ptr(), stream)
    LIBRARY.launches += 1
    return sw, bn

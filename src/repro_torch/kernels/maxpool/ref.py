"""Plain PyTorch version of the 3x3 max / argmax / min pools (the kernel's
oracle).

Counterpart of ``repro.kernels.maxpool.ref`` (paper Algorithm 1 lines 1
and 6: ``maxpool2d`` / ``arg-maxpool2d`` with kernel 3, stride 1, pad 1).
Images may carry leading batch dimensions; the argmax is the flat index
inside each (H, W) image.

* The argmax follows the total order ``(value, flat_index)``: among equal
  values the larger flat index wins, and an out-of-image cell (index -1)
  never wins, whatever the image holds (uint8's pad fill 0 and int32's
  ``iinfo.min`` are real pixel values).
* Pooled values follow ``jnp.maximum`` / ``jnp.minimum``, which order
  ``-0.0`` below ``+0.0``; every other pair of equal values has equal bits,
  so the pooled value is unique.

This is the CPU path and the version the CUDA kernel (``kernel.py``) is
held to bitwise on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.grid import neg_inf, pos_inf, shift2d

# (dr, dc) offsets of the 3x3 window, self included, in flat-index order.
OFFSETS = [(-1, -1), (-1, 0), (-1, 1),
           (0, -1), (0, 0), (0, 1),
           (1, -1), (1, 0), (1, 1)]


def _greater(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a > b`` with ``-0.0 < +0.0`` for floats."""
    gt = a > b
    if a.dtype.is_floating_point:
        gt = gt | ((a == b) & torch.signbit(b) & ~torch.signbit(a))
    return gt


def _pool(x: torch.Tensor, minimum: bool) -> torch.Tensor:
    fill = pos_inf(x.dtype) if minimum else neg_inf(x.dtype)
    out = x
    for dr, dc in OFFSETS:
        if (dr, dc) == (0, 0):
            continue
        v = shift2d(x, dr, dc, fill)
        take = _greater(out, v) if minimum else _greater(v, out)
        out = torch.where(take, v, out)
    return out


def maxpool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 max pool (any dtype)."""
    return _pool(x, minimum=False)


def minpool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / pad-1 min pool (``-maxpool2d(-x)`` in the paper)."""
    return _pool(x, minimum=True)


def argmaxpool3x3(x: torch.Tensor) -> torch.Tensor:
    """Flat index (int32) of each 3x3 window's maximum under the
    ``(value, flat_index)`` order; border windows are truncated."""
    h, w = x.shape[-2:]
    flat = torch.arange(h * w, dtype=torch.int32,
                        device=x.device).reshape(h, w)
    fill = neg_inf(x.dtype)
    best_v = x
    best_i = flat.expand(x.shape)
    for dr, dc in OFFSETS:
        if (dr, dc) == (0, 0):
            continue
        v = shift2d(x, dr, dc, fill)
        i = shift2d(flat, dr, dc, -1)
        better = (v > best_v) | ((v == best_v) & (i > best_i))
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, i, best_i)
    return best_i


def maxargmaxpool3x3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(maxpool3x3, argmaxpool3x3)`` — what the kernel computes."""
    return maxpool3x3(x), argmaxpool3x3(x)

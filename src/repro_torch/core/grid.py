"""Shared 2D grid utilities for the 8-neighborhood stencils (PyTorch).

Counterpart of ``repro.core.grid``: ``NEIGHBOR_OFFSETS`` fixes the
8-neighborhood iteration order once, ``shift2d`` is the single source of
neighbor access (constant fill, one-pixel halo), ``fixed_point_iterate``
is the pointer-chase loop every label/root resolution runs on, and
``higher_neighbor_basins`` is the flat-index gather the merge sweep and
the Boruvka edge generator share.  Every function works on tensors of any
device; nothing here moves data between devices.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import telemetry

# 8-neighborhood offsets (self excluded), fixed order: every consumer uses
# the same order so merge processing is bit-identical across layers.
NEIGHBOR_OFFSETS = [(-1, -1), (-1, 0), (-1, 1),
                    (0, -1), (0, 1),
                    (1, -1), (1, 0), (1, 1)]


def neg_inf(dtype: torch.dtype):
    """The minimal sentinel of ``dtype`` (stencil fill: never wins a max)."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def pos_inf(dtype: torch.dtype):
    """The maximal sentinel of ``dtype`` (min-pool fill)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def fixed_point_iterate(step: Callable[[torch.Tensor], torch.Tensor],
                        x0: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Iterate ``x <- step(x)`` until unchanged; one ``step`` per iteration.

    Returns ``(x, n_steps)`` where ``n_steps`` counts the ``step``
    evaluations, including the final one that verifies the fixed point.
    Each iteration reads one flag back to the host (one ``readbacks``).
    """
    x, k = x0, 0
    while True:
        x2 = step(x)
        k += 1
        telemetry.readback()
        if not bool((x2 != x).any()):
            return x2, k
        x = x2


def gather_flat(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[..., index]`` along the last axis (``q[q]`` with batch dims)."""
    if table.dim() == 1:
        return table[index.long()]
    return torch.gather(table, -1, index.long())


def shift2d(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """Return y with ``y[..., r, c] = x[..., r + dr, c + dc]``, ``fill``
    outside.  Supports the 3x3 stencil offsets ``dr, dc in {-1, 0, 1}``;
    leading dimensions are batch dimensions."""
    if not (-1 <= dr <= 1 and -1 <= dc <= 1):
        raise ValueError(f"shift2d supports |dr|,|dc| <= 1, got ({dr}, {dc})")
    h, w = x.shape[-2:]
    # Filled by torch.full_like, not F.pad: F.pad takes its fill as a
    # double, which rounds int64 sentinels such as iinfo(int64).max.
    out = torch.full_like(x, fill)
    r0, r1 = max(0, -dr), min(h, h - dr)
    c0, c1 = max(0, -dc), min(w, w - dc)
    if r0 < r1 and c0 < c1:
        out[..., r0:r1, c0:c1] = x[..., r0 + dr:r1 + dr, c0 + dc:c1 + dc]
    return out


def higher_neighbor_basins(x: torch.Tensor, xkey: torch.Tensor,
                           key_flat: torch.Tensor, labels_flat: torch.Tensor,
                           shape: tuple[int, int],
                           valid=True) -> tuple[torch.Tensor, torch.Tensor]:
    """Per 8-neighbor of flat pixel ids ``x``: (strictly-higher?, basin).

    ``key_flat`` is any order-isomorphic encoding of the ``(value, index)``
    total order (int32 ranks or packed int64 keys); only ``>`` is applied
    to it.  Returns ``(ok, basin)`` with a trailing 8-slot axis in
    :data:`NEIGHBOR_OFFSETS` order: ``ok`` is in-bounds AND strictly
    higher AND ``valid``; ``basin`` is ``labels_flat`` at the (clamped)
    neighbor — garbage where ``ok`` is False.  Leading axes of ``x``,
    ``key_flat`` and ``labels_flat`` are batch axes (one image each).
    """
    h, w = shape
    n = h * w
    xr = torch.div(x, w, rounding_mode="floor")
    xc = x - xr * w
    oks, basins = [], []
    for dr, dc in NEIGHBOR_OFFSETS:
        rr, cc = xr + dr, xc + dc
        inb = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
        nid = torch.clamp(rr * w + cc, 0, n - 1).long()
        higher = gather_flat(key_flat, nid) > xkey
        oks.append(inb & higher & valid)
        basins.append(gather_flat(labels_flat, nid))
    return torch.stack(oks, dim=-1), torch.stack(basins, dim=-1)

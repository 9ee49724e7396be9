"""Plain PyTorch version of the fused phase-A stage (the kernel's oracle).

Counterpart of ``repro.kernels.ph_phase_a.ref``.  Phase A turns an image
into the two per-pixel artifacts the rest of PixHomology consumes:

* ``ptr`` — the strip-snapped steepest-ascent pointer: each pixel's ascent
  chain is followed while it stays inside the pixel's ``strip_rows``-row
  strip, then one half-hop is taken, so ``ptr[i]`` is a basin root or a
  pixel in a boundary row of an adjacent strip;
* ``hi_mask`` — the int32 bitmask over ``NEIGHBOR_OFFSETS`` (bit j set iff
  neighbor j is inside the image and strictly higher under the
  (value, flat index) total order).

This is the CPU path and the version the CUDA kernel (``kernel.py``) is
held to bitwise on the card.  Images may carry leading batch dimensions;
outputs are then ``(..., H*W)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.grid import (NEIGHBOR_OFFSETS, fixed_point_iterate,
                                   gather_flat, neg_inf, shift2d)


def pointer_and_mask_sweep(image: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One 8-offset sweep emitting (steepest pointer, higher bitmask), 2D.

    Out-of-image neighbors carry index -1, so they never win the argmax
    nor count as higher, even for images containing the fill value.
    """
    h, w = image.shape[-2:]
    flat = torch.arange(h * w, dtype=torch.int32,
                        device=image.device).reshape(h, w)
    fill = neg_inf(image.dtype)
    best_v = image
    best_i = flat.expand(image.shape)
    mask = torch.zeros(image.shape, dtype=torch.int32, device=image.device)
    for j, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        v = shift2d(image, dr, dc, fill)
        i = shift2d(flat, dr, dc, -1)
        better = (v > best_v) | ((v == best_v) & (i > best_i))
        best_v = torch.where(better, v, best_v)
        best_i = torch.where(better, i, best_i)
        higher = v > image
        if (dr, dc) > (0, 0):      # neighbor flat index > self on value ties
            higher = higher | (v == image)
        mask = mask | torch.where((i >= 0) & higher, 1 << j, 0).to(
            torch.int32)
    return best_i, mask


def phase_a(image: torch.Tensor, *, strip_rows: int = 8,
            with_stats: bool = False):
    """Fused phase A: ``(ptr, hi_mask)`` flat int32 of an (H, W) image or
    an (B, H, W) batch.  ``with_stats`` also returns the snap's iteration
    count."""
    h, w = image.shape[-2:]
    n = h * w
    srows = max(1, min(strip_rows, h))
    span = w * srows                 # strip id of flat pixel g = g // span

    hop2d, mask2d = pointer_and_mask_sweep(image)
    hop = hop2d.reshape(*image.shape[:-2], n)
    hi_mask = mask2d.reshape(*image.shape[:-2], n)

    idx = torch.arange(n, dtype=torch.int32, device=image.device)
    esc = hop // span != idx // span                   # hop leaves the strip
    m0 = torch.where(esc, idx, hop)                    # freeze escapes
    m, snap_iters = fixed_point_iterate(lambda q: gather_flat(q, q), m0)
    hm = gather_flat(hop, m)                           # half-hop out
    ptr = torch.where(hm // span != m // span, hm, m)
    if with_stats:
        return ptr, hi_mask, snap_iters
    return ptr, hi_mask

"""Public entry of the fused phase-A stage, dispatched by tensor device.

A CUDA tensor runs the hand-written kernel (``kernel.py``) unless the
caller passes ``use_pallas=False``, which selects the plain version
explicitly (what the on-card comparison runs).  A CPU tensor runs the
plain version (``ref.py``).  There is no fallback from the kernel to the
plain version: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ph_phase_a import kernel, ref


def boundary_rows(h: int, strip_rows: int) -> np.ndarray:
    """Sorted first/last image rows of every ``strip_rows``-row strip: the
    static frontier a strip-snapped pointer that is not a root lands in."""
    s = max(1, min(strip_rows, h))
    rows = set()
    for r0 in range(0, h, s):
        rows.add(r0)
        rows.add(min(h, r0 + s) - 1)
    return np.asarray(sorted(rows), np.int32)


def fused_phase_a(image: torch.Tensor, *, strip_rows: int = 8,
                  use_pallas: bool | None = None):
    """Fused phase A: ``(ptr, hi_mask)`` flat int32 arrays of ``image``
    ((H, W) or (B, H, W)); both versions are bitwise equal."""
    if image.is_cuda and use_pallas is not False:
        return kernel.phase_a(image, strip_rows=strip_rows)
    return ref.phase_a(image, strip_rows=strip_rows)

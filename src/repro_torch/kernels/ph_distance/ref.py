"""Plain PyTorch version of the diagram-distance pair grid (the kernel's
oracle), and the preparation stages both versions consume.

Counterpart of ``repro.kernels.ph_distance.ref``.  Two stages:

1. **Preparation** (per diagram, plain PyTorch on the diagrams' device,
   shared by the kernel and this version): :func:`diagram_projections`
   turns each capacity-padded diagram into its direction projections and
   diagonal projections, :func:`persistence_profiles` into its descending
   persistence profile.
2. **Pair reduction** (per (i, j) pair): :func:`pair_distances`, looped
   over the grid by :func:`distance_matrix`; the CUDA kernel
   (``kernel.py``) computes the same grid.

Distances, for 0-dim diagrams padded to capacity ``F``:

``sw``
    Sliced Wasserstein: for each direction ``θ_k``, diagram A's projected
    points are augmented with the diagonal projections of B's points (and
    vice versa), both 2F-vectors are sorted, and the 1-D W1 distance is
    their elementwise L1 **sum**; ``sw`` averages the K directions.
``bn``
    Bottleneck lower bound: ``max_k |pA_(k) - pB_(k)| / 2`` over the
    descending persistence profiles.

**Capacity-pad inertness.** Pad rows (``p_birth < 0``) become the diagonal
point (0, 0) before projection, so a pad adds a 0 to both sorted vectors
of every pair (1-D transport between sorted vectors is unchanged by equal
insertions) and a 0 to both profiles; distances do not depend on the
capacity.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.packed_keys import (key_pad, masked_top_k,
                                          monotone_key32, pack_keys,
                                          packable_dtype)

__all__ = ["canonical_points", "diagram_projections", "distance_matrix",
           "pair_distances", "persistence_profiles"]


def canonical_points(birth, death, p_birth):
    """Pad rows -> the diagonal point (0, 0); returns ``(b, d, valid)``.
    Valid rows of engine diagrams are finite, so the projections never
    see the pad rows' ±inf sentinels."""
    valid = p_birth >= 0
    zero = torch.zeros((), dtype=birth.dtype, device=birth.device)
    return torch.where(valid, birth, zero), torch.where(valid, death, zero), \
        valid


def _directions(n_dirs: int, dtype, device):
    """K half-circle directions, midpoints of equal angular bins.

    The angles are formed in ``dtype`` as the reference forms them; their
    cosines and sines are taken in float64 on the host and rounded once,
    so every device gets the same bits (float32 ``cos`` differs by an ulp
    between backends, the reference's XLA among them).
    """
    k = torch.arange(n_dirs, dtype=dtype)
    theta = ((k + 0.5) * (math.pi / n_dirs)).double()
    return (torch.cos(theta).to(device=device, dtype=dtype),
            torch.sin(theta).to(device=device, dtype=dtype))


def diagram_projections(birth, death, p_birth, *, n_dirs: int = 16):
    """Per-diagram projection tables ``(pts, diag)``, each (..., K, F):
    point f on direction k, and the projection of its nearest diagonal
    point ``((b+d)/2, (b+d)/2)``.  Pad rows project to 0 on both."""
    b, d, _ = canonical_points(birth, death, p_birth)
    ct, st = _directions(n_dirs, b.dtype, b.device)
    pts = b[..., None, :] * ct[:, None] + d[..., None, :] * st[:, None]
    mid = (b + d) * 0.5
    diag = mid[..., None, :] * (ct + st)[:, None]
    return pts, diag


def persistence_profiles(birth, death, p_birth, *, merge_keys: str = "rank",
                         width: int = 2):
    """Descending persistence profile per diagram: (..., F).

    Persistence is ``|birth - death|`` on valid rows and exactly 0 on pads.
    Selection uses the package's top-k primitive on packed int64 keys or
    32-bit monotone keys; tie *order* may differ between encodings, the
    selected values (all a profile is) do not.
    """
    b, d, valid = canonical_points(birth, death, p_birth)
    pers = torch.abs(b - d)

    def row(p, v):
        f = p.shape[0]
        if merge_keys == "packed":
            keys = pack_keys(p)
        elif packable_dtype(p.dtype):
            keys = monotone_key32(p)
        else:
            top = torch.topk(torch.where(v, p, -torch.ones_like(p)), f)[0]
            return torch.clamp(top, min=0)
        top, pos = masked_top_k(keys, v, f, width)
        return torch.where(top > key_pad(top.dtype), p[pos.long()],
                           torch.zeros_like(p))

    if pers.dim() == 1:
        return row(pers, valid)
    flat = pers.reshape(-1, pers.shape[-1])
    vflat = valid.reshape(-1, valid.shape[-1])
    out = torch.stack([row(flat[i], vflat[i]) for i in range(flat.shape[0])])
    return out.reshape(pers.shape)


def pair_distances(pts_a, diag_a, prof_a, pts_b, diag_b, prof_b):
    """One (A, B) pair: ``(sw, bn)`` 0-d tensors (sum along 2F, then the
    mean along K)."""
    va = torch.sort(torch.cat([pts_a, diag_b], dim=-1), dim=-1).values
    vb = torch.sort(torch.cat([pts_b, diag_a], dim=-1), dim=-1).values
    w1 = torch.sum(torch.abs(va - vb), dim=-1)       # (K,) per direction
    sw = torch.sum(w1, dim=-1) / w1.shape[-1]
    bn = 0.5 * torch.max(torch.abs(prof_a - prof_b), dim=-1).values
    return sw, bn


def distance_matrix(pts, diag, prof):
    """Full (B, B) grid of :func:`pair_distances` -> ``(sw, bn)``."""
    n = pts.shape[0]
    sw = torch.empty((n, n), dtype=pts.dtype, device=pts.device)
    bn = torch.empty((n, n), dtype=prof.dtype, device=prof.device)
    for i in range(n):
        for j in range(n):
            sw[i, j], bn[i, j] = pair_distances(pts[i], diag[i], prof[i],
                                                pts[j], diag[j], prof[j])
    return sw, bn

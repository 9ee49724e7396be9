"""Bucket padding and pad-artifact repair for padded dispatches.

Counterpart of ``repro.pipeline.padding``; the engine's mixed-shape
:meth:`repro_torch.ph.PHEngine.run_batch` stages images of several shapes
into one padded ``(B, Hb, Wb)`` dispatch.  Images are host tensors and
diagrams are :class:`repro_torch.core.Diagram` tensors on any device
(bfloat16 has no numpy dtype without an extension package, so the copy
works on tensors).  The exactness argument, for the superlevel filtration
with the sublevel dual in parentheses:

* pad pixels hold the *inert extreme* of the filtration — the dtype
  minimum / ``-inf`` (``+inf``) — so under a finite per-image Variant-2
  threshold they produce no births, no candidates and no merges;
* without a filter-level threshold the **image minimum** (maximum) is an
  exact substitute: it keeps every real pixel and drops every pad pixel
  (the essential death it clips is restored by the fixup below);
* the two residual artifacts are repaired after compute: flat indices
  are strided by the bucket width instead of the image width (a pure
  remap — right/bottom padding keeps the row order of real pixels), and
  the essential class dies at the recorded image minimum (maximum)
  instead of the pad fill.

:func:`pad_fixup` captures the metadata at staging time and
:func:`unpad_diagram` applies the repair, making a padded row bitwise
equal to the unpadded run (``p_birth``/``p_death`` included).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.grid import neg_inf, pos_inf
from repro_torch.core.packed_keys import resolve_filtration
from repro_torch.core.pixhomology import Diagram


def pad_fill_value(dtype: torch.dtype, filtration: str = "superlevel"):
    """The inert fill for pad pixels of ``dtype`` under ``filtration``:
    below everything for superlevel, above everything for sublevel."""
    resolve_filtration(filtration)
    if filtration == "sublevel":
        if not dtype.is_floating_point:
            raise ValueError(f"filtration='sublevel' requires a floating "
                             f"dtype, got {dtype}")
        return pos_inf(dtype)
    return neg_inf(dtype)


def pad_threshold(img: torch.Tensor, threshold: float | None,
                  filtration: str = "superlevel") -> float:
    """The finite threshold a padded dispatch of ``img`` runs under.

    An explicit finite ``threshold`` passes through; otherwise the image
    extreme stands in — the minimum under superlevel, the maximum under
    sublevel.  Raises when no finite threshold separates the image from
    the pad fill (an integer image whose minimum is the dtype minimum is
    indistinguishable from its own padding).
    """
    if threshold is not None and math.isfinite(threshold):
        return float(threshold)
    fill = pad_fill_value(img.dtype, filtration)
    if filtration == "sublevel":
        t = float(img.max())
        bad = not math.isfinite(t) or t >= fill
    else:
        t = float(img.min())
        bad = not math.isfinite(t) or t <= fill
    if bad:
        raise ValueError(
            f"cannot pad image: no finite threshold separating the pad "
            f"fill {fill!r} from the image extreme {t!r}; pass an "
            f"explicit truncate_value or use exact-shape batches")
    return t


def pad_fixup(img: torch.Tensor, filtration: str = "superlevel"
              ) -> tuple[int, int, torch.Tensor, int]:
    """Repair metadata of one to-be-padded image: ``(H, W, ext_val,
    ext_idx)``, the index flat in the *unpadded* frame.  The extreme is the
    essential death point of the filtration (global minimum under
    superlevel, maximum under sublevel); ``argmin``/``argmax`` return the
    first occurrence, the pixel the ``(value, index)`` order picks."""
    resolve_filtration(filtration)
    h, w = img.shape
    flat = img.reshape(-1)
    ei = int(flat.argmax() if filtration == "sublevel" else flat.argmin())
    return h, w, flat[ei], ei


def pad_image(img: torch.Tensor, bucket: tuple[int, int],
              filtration: str = "superlevel") -> torch.Tensor:
    """Right/bottom-pad ``img`` to ``bucket`` with the inert fill (the row
    order of real pixels is kept, so :func:`unpad_diagram`'s stride remap
    is exact)."""
    h, w = img.shape
    hb, wb = bucket
    if (h, w) == (hb, wb):
        return img
    if h > hb or w > wb:
        raise ValueError(f"image {tuple(img.shape)} exceeds bucket {bucket}")
    out = torch.full((hb, wb), pad_fill_value(img.dtype, filtration),
                     dtype=img.dtype, device=img.device)
    out[:h, :w] = img
    return out


def unpad_diagram(d: Diagram, fixup, bucket: tuple[int, int]) -> Diagram:
    """Undo the two pad artifacts of a bucket-padded image's diagram.

    ``fixup = (H, W, ext_val, ext_idx)`` from :func:`pad_fixup`.  Flat
    indices move from stride ``Wb`` to stride ``W`` and row 0 (the
    essential class under both filtrations) dies at the recorded extreme,
    when the diagram has any row.  Runs on the diagram's device without
    reading anything back.
    """
    _, w, env, eni = fixup
    wb = bucket[1]

    def remap(p):
        return torch.where(p >= 0, (p // wb) * w + p % wb, p)

    p_birth = remap(d.p_birth)
    p_death = remap(d.p_death)
    has_row = d.count > 0
    first = torch.zeros_like(p_death, dtype=torch.bool)
    first[0] = True
    death = torch.where(first & has_row,
                        env.to(device=d.death.device, dtype=d.death.dtype),
                        d.death)
    p_death = torch.where(first & has_row, eni, p_death)
    return Diagram(d.birth, death, p_birth, p_death, d.count, d.n_unmerged,
                   d.overflow)

"""Dispatch + whole-batch driver of the diagram-distance pair grid.

Counterpart of ``repro.kernels.ph_distance.ops``:

* :func:`pairwise_distances` — the (B, B) pair reduction over prepared
  projection/profile tables: a CUDA tensor runs the hand-written kernel
  unless ``use_pallas=False`` selects the plain version explicitly; a CPU
  tensor runs the plain version.  No fallback from the kernel.
* :func:`diagram_distances` — capacity-padded diagrams in, ``(sw, bn)``
  out.  The preparation stages (projections, profiles) are the same plain
  PyTorch code whichever version reduces the pairs, so the choice cannot
  change a bit of the reduction's input.

Diagram values are checked with
:func:`repro_torch.core.packed_keys.check_finite` (``allow_inf``: pad rows
carry the ±inf sentinels of their filtration, a NaN cannot be ordered).
"""
from __future__ import annotations

from repro_torch.core.packed_keys import check_finite
from repro_torch.kernels.ph_distance import kernel, ref


def pairwise_distances(pts, diag, prof, *, use_pallas: bool | None = None):
    """Pair-grid ``(sw, bn)`` matrices from prepared tables."""
    if pts.is_cuda and use_pallas is not False:
        return kernel.distance_matrix(pts, diag, prof)
    return ref.distance_matrix(pts, diag, prof)


def diagram_distances(birth, death, p_birth, *, n_dirs: int = 16,
                      merge_keys: str = "rank", width: int = 2,
                      use_pallas: bool | None = None):
    """Distance matrices of a batch of capacity-padded diagrams.

    ``birth``/``death``: (B, F) float tensors; ``p_birth``: (B, F) int32
    with -1 on pad rows (the stacked ``Diagram`` layout).  Returns
    ``(sw, bn)``, both (B, B): sliced Wasserstein and the bottleneck
    lower bound (see ``ref``).
    """
    if birth.dim() != 2:
        raise ValueError(f"diagram_distances expects stacked (B, F) "
                         f"diagrams, got shape {tuple(birth.shape)}")
    check_finite(birth, where="diagram births", allow_inf=True)
    check_finite(death, where="diagram deaths", allow_inf=True)
    pts, diag = ref.diagram_projections(birth, death, p_birth, n_dirs=n_dirs)
    prof = ref.persistence_profiles(birth, death, p_birth,
                                    merge_keys=merge_keys, width=width)
    return pairwise_distances(pts.contiguous(), diag.contiguous(),
                              prof.contiguous(), use_pallas=use_pallas)

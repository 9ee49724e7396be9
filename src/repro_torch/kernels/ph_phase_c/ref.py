"""Plain PyTorch version of the phase-C best-edge reduction (the oracle).

The reduction lives in :func:`repro_torch.core.parallel_merge.best_edge_reduce`,
the factored round body of ``boruvka_forest``; this module re-exports it
under the kernel-package layout, mirroring ``repro.kernels.ph_phase_c.ref``.
Both of its passes are integer max reductions, so the CUDA kernel's
atomics, landing in any order, give the same bits.
"""
from __future__ import annotations

from repro_torch.core.parallel_merge import best_edge_reduce  # noqa: F401

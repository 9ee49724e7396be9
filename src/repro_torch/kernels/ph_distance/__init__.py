"""Batched persistence-diagram distances (sliced Wasserstein + bottleneck
lower bound).

``ops.pairwise_distances`` dispatches the pair grid between the CUDA
kernel (``kernel.py``, ``csrc/distance.cu``) and the plain PyTorch version
(``ref.py``); the projection and profile preparation in ``ref`` is shared
by both.
"""
from repro_torch.kernels.ph_distance.ops import (  # noqa: F401
    diagram_distances,
    pairwise_distances,
)
from repro_torch.kernels.ph_distance.ref import (  # noqa: F401
    diagram_projections,
    pair_distances,
    persistence_profiles,
)

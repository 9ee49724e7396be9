"""Bounded caches for PH results: the delta-recompute frame store and the
serving daemon's exact-result tier.

:class:`DiagramCache` keys device-resident per-frame tiled state
(:class:`repro_torch.core.tiling.TileBoundaryState`) by ``(context,
tile-hash grid)`` and answers three questions in one lookup: identical
frame (full hit — the cached diagram is returned without touching the
device), near-duplicate frame (partial hit — the clean-tile subset of the
state is reusable), or miss.  :class:`LRUCache` is the generic bounded
mapping the serving cache tier uses for exact request-hash results.
"""
from repro_torch.cache.diagram_cache import (  # noqa: F401
    CacheStats,
    DiagramCache,
    FrameCacheEntry,
    LRUCache,
)

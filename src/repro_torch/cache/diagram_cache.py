"""Bounded LRU stores behind delta recompute and the serving cache tier.

The port's own copy of ``repro.cache.diagram_cache`` (numpy only; the
cached state is whatever tensors the engine hands in, and stays on their
device).  Two layers share this module:

* :class:`DiagramCache` — the **frame store** for
  :meth:`repro_torch.ph.PHEngine.run_delta`.  One entry per cached frame:
  the per-tile content-hash grid, the device-resident
  :class:`repro_torch.core.tiling.TileBoundaryState`, the finished
  :class:`repro_torch.ph.PHResult`, and the capacities the state was
  built at.
  ``lookup`` classifies an incoming frame against the store (full hit /
  partial hit with a dirty mask / miss) in one call, so the engine's
  delta path is a straight line.  Entries are keyed by ``(context,
  digests)`` where ``context`` pins everything that must match for a
  cached state row to be *bit-reusable*: image shape, grid, dtype,
  threshold, hash algorithm, and the config plan key.  The threshold is
  part of the context on purpose — a Variant-2 threshold filters
  candidates and roots *inside* phase B, so state computed under a
  different threshold is not reusable (a changed threshold is a full
  miss, never a wrong answer).

* :class:`LRUCache` — a generic bounded mapping with hit/miss/evict
  counters; the serving daemon keys finished results by the exact
  request hash so repeated requests bypass the queue entirely.

Eviction policy (both layers): least-recently-*used* — every full or
partial hit refreshes the entry; inserting past ``capacity`` evicts the
stalest entry and counts it.  Collision policy: by default a 128-bit
content hash is trusted (the engineering-standard birthday bound); with
``DeltaSpec.verify`` the caller passes the raw tile bytes and every
clean classification is byte-compared — a collision is then *detected*:
the tile is reclassified dirty (harmless, just recomputed) and counted
in ``stats.collisions``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any

import numpy as np


@dataclasses.dataclass
class CacheStats:
    """Counters for one cache instance (snapshot-friendly)."""

    hits: int = 0            # full hits: identical frame / exact request
    partial_hits: int = 0    # near-duplicate: subset of tiles dirty
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    collisions: int = 0      # verify-mode digest collisions caught

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FrameCacheEntry:
    """One cached frame of the delta store.

    ``state`` is the stacked per-tile :class:`TileBoundaryState` exactly
    as the scatter-merge step produced it (device-resident — reusing it
    costs no host round-trip).  ``capacities`` records the
    ``(max_features, tile_max_features, tile_max_candidates)`` the state
    was built at: a partial hit requires equal capacities (state arrays
    are shape-static), while a full hit does not (the finished result is
    returned as-is).  ``tile_bytes`` is populated only in verify mode.
    """

    digests: tuple[bytes, ...]
    state: Any
    result: Any
    capacities: tuple[int, int, int]
    tile_bytes: tuple[bytes, ...] | None = None


class LRUCache:
    """Thread-safe bounded mapping with LRU eviction and counters."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key):
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return got

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self._entries[key] = value
            self.stats.inserts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1


class DiagramCache:
    """Bounded LRU of :class:`FrameCacheEntry` keyed by (context, digests).

    ``lookup`` is the single classification entry point; ``put`` inserts
    or refreshes.  Near-duplicate matching scans same-context entries and
    picks the one with the most clean tiles — the store is small by
    design (``DeltaSpec.cache_entries``), so the scan is O(entries).
    """

    def __init__(self, capacity: int = 4):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: collections.OrderedDict[tuple, FrameCacheEntry] = \
            collections.OrderedDict()
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _verified_clean(self, entry: FrameCacheEntry, clean: np.ndarray,
                        tile_bytes) -> np.ndarray:
        """Byte-compare verify pass: demote hash-clean tiles whose bytes
        actually differ (a detected collision) to dirty."""
        if tile_bytes is None or entry.tile_bytes is None:
            return clean
        out = clean.copy()
        for t in np.flatnonzero(clean):
            if entry.tile_bytes[t] != tile_bytes[t]:
                out[t] = False
                self.stats.collisions += 1
        return out

    def lookup(self, context: tuple, digests: tuple[bytes, ...],
               capacities: tuple[int, int, int] | None = None,
               tile_bytes: tuple[bytes, ...] | None = None
               ) -> tuple[str, FrameCacheEntry | None, np.ndarray | None]:
        """Classify a frame: ``("hit", entry, None)`` for an identical
        frame, ``("partial", entry, dirty_mask)`` for the best
        same-context near-duplicate (fewest dirty tiles; requires
        matching ``capacities``), else ``("miss", None, None)``.

        ``tile_bytes`` (verify mode) demotes colliding tiles to dirty
        before classification — a full-grid collision therefore degrades
        to a partial/miss instead of returning a stale diagram.
        """
        with self._lock:
            exact = self._entries.get((context, digests))
            if exact is not None:
                clean = np.ones(len(digests), bool)
                clean = self._verified_clean(exact, clean, tile_bytes)
                if clean.all():
                    self._entries.move_to_end((context, digests))
                    self.stats.hits += 1
                    return "hit", exact, None
                # collision inside an exact-digest match: fall through to
                # the partial path with the demoted mask
                if capacities is None or exact.capacities == capacities:
                    self._entries.move_to_end((context, digests))
                    self.stats.partial_hits += 1
                    return "partial", exact, ~clean
            best_key, best_clean = None, None
            for key, entry in self._entries.items():
                if key[0] != context or len(key[1]) != len(digests):
                    continue
                if capacities is not None and \
                        entry.capacities != capacities:
                    continue
                clean = np.array([a == b for a, b in
                                  zip(key[1], digests)], bool)
                clean = self._verified_clean(entry, clean, tile_bytes)
                if best_clean is None or clean.sum() > best_clean.sum():
                    best_key, best_clean = key, clean
            if best_key is not None and best_clean.any():
                self._entries.move_to_end(best_key)
                self.stats.partial_hits += 1
                return "partial", self._entries[best_key], ~best_clean
            self.stats.misses += 1
            return "miss", None, None

    def put(self, context: tuple, entry: FrameCacheEntry) -> None:
        with self._lock:
            key = (context, entry.digests)
            if key in self._entries:
                self._entries.move_to_end(key)
            self._entries[key] = entry
            self.stats.inserts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

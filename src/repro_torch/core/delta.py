"""Delta recompute on the tiled stage graph: O(changed area) per frame.

Counterpart of ``repro.core.delta``.  Every per-tile artifact
(:class:`repro_torch.core.tiling.TileBoundaryState`) is a pure function of
that tile's **halo-padded bytes**, and only the O(boundary) seam merge
(:func:`repro_torch.core.tiling.merge_tile_state`) mixes tiles.  So a
frame that changed in ``D`` of ``T`` tiles needs:

1. a host hash pass over the tile bytes classifying tiles clean/dirty
   against a cached frame's hash grid;
2. phases A+B for the ``D`` dirty tiles only, through the same stacked
   :func:`repro_torch.core.tiling.tile_phase_ab` the cold path runs (dirty
   counts pad to power-of-two buckets, as in the reference);
3. a scatter of the fresh rows into a copy of the cached state and one
   seam-merge replay — **bit-identical** to a cold ``run_tiled`` because
   clean rows store pre-labels, not stale resolved labels.

Each step is a :mod:`repro_torch.telemetry` span: ``delta.hash``
(:func:`frame_digests`), ``delta.stage`` (:func:`dirty_stacks`, the dirty
windows' copy through their upload) and ``delta.scatter`` (the scatter in
:func:`scatter_merge`, timed on the device by its CUDA events).

Hashing covers the halo-*padded* window of each tile, so a change in a
neighbor's border row dirties this tile too.  The engine surface is
:meth:`repro_torch.ph.PHEngine.run_delta` / ``run_sequence``; the frame
store is :class:`repro_torch.cache.DiagramCache`.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import packed_keys
from repro_torch.core.grid import neg_inf
from repro_torch.core.tiling import (StagedTiles, TileBoundaryState,
                                     TiledDiagram, _ring_coords, _tile_dims,
                                     halo_gidx_stack, internal_threshold,
                                     merge_tile_state, negate_diagram,
                                     tile_phase_ab, validate_grid)

HASH_ALGOS = ("blake2b", "sha1", "md5")


@dataclasses.dataclass(frozen=True)
class DeltaStats:
    """What one ``run_delta`` call actually did."""

    n_tiles: int
    n_dirty: int               # tiles recomputed (0 on a full hit)
    hit: str                   # "full" | "partial" | "miss" | "cold"

    @property
    def dirty_frac(self) -> float:
        return self.n_dirty / max(self.n_tiles, 1)


# ---------------------------------------------------------------------------
# Content hashing (host side)
# ---------------------------------------------------------------------------

def hasher(algo: str):
    """Digest function for ``algo`` (128-bit blake2b by default)."""
    if algo == "blake2b":
        return lambda b: hashlib.blake2b(b, digest_size=16).digest()
    if algo in HASH_ALGOS:
        return lambda b: hashlib.new(algo, b).digest()
    raise ValueError(f"hash_algo must be one of {HASH_ALGOS}, got {algo!r}")


def _tile_bytes(tile: torch.Tensor) -> bytes:
    """The bytes of one halo tile on the host (bfloat16 as its bits)."""
    telemetry.readback(tile.device)
    tile = tile.detach().cpu().contiguous()
    if tile.dtype == torch.bfloat16:
        tile = tile.view(torch.int16)
    return tile.numpy().tobytes()


def _padded_host(arr: torch.Tensor, filtration: str) -> torch.Tensor:
    """The frame with its 1-px halo of the user-space inert fill."""
    fill = neg_inf(arr.dtype)
    if filtration == "sublevel":
        fill = -fill
    h, w = arr.shape
    padded = torch.full((h + 2, w + 2), fill, dtype=arr.dtype)
    padded[1:-1, 1:-1] = arr
    return padded


def _window(padded: torch.Tensor, grid, t: int) -> torch.Tensor:
    tr, tc = (padded.shape[0] - 2) // grid[0], (padded.shape[1] - 2) // grid[1]
    r0, c0 = (t // grid[1]) * tr, (t % grid[1]) * tc
    return padded[r0:r0 + tr + 2, c0:c0 + tc + 2]


def _host_frame(source) -> torch.Tensor:
    arr = source if isinstance(source, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(source))
    if arr.dim() != 2:
        raise ValueError(f"expected a 2D frame, got shape {tuple(arr.shape)}")
    telemetry.readback(arr.device)
    return arr.detach().cpu()


def frame_digests(source, grid: tuple[int, int], *, algo: str = "blake2b",
                  with_bytes: bool = False, filtration: str = "superlevel"
                  ) -> tuple[tuple[bytes, ...], tuple[bytes, ...] | None]:
    """Per-tile content digests of one frame's **halo-padded** tile bytes.

    ``source`` is a host 2D array/tensor or a :class:`StagedTiles` (read
    back one tile at a time).  Both hash exactly the bytes of
    ``split_tiles(image, grid, fill)`` rows, so entries created from
    either input form match each other — the halo fill is the user-space
    inert extreme of ``filtration`` (``+inf`` under sublevel), as
    :func:`repro_torch.core.tiling.load_tile_stacks` stages it.  Returns
    ``(digests, tile_bytes)``, the raw bytes only when ``with_bytes``
    (verify mode).
    """
    h = hasher(algo)
    with telemetry.span("delta.hash"):
        if isinstance(source, StagedTiles):
            rows = [_tile_bytes(source.pvals[t])
                    for t in range(source.pvals.shape[0])]
        else:
            arr = _host_frame(source)
            validate_grid(tuple(arr.shape), tuple(grid))
            padded = _padded_host(arr, filtration)
            rows = [_tile_bytes(_window(padded, grid, t))
                    for t in range(grid[0] * grid[1])]
        digests = tuple(h(b) for b in rows)
    return digests, (tuple(rows) if with_bytes else None)


def dirty_bucket(n_dirty: int, n_tiles: int) -> int:
    """Dirty-stack batch size: next power of two, clamped to the tile
    count (the reference's compiled batch shapes; the port keeps the
    bucket so both packages stage the same stacks)."""
    if n_dirty < 1:
        raise ValueError("dirty_bucket needs n_dirty >= 1")
    return min(n_tiles, 1 << (n_dirty - 1).bit_length())


# ---------------------------------------------------------------------------
# State plumbing
# ---------------------------------------------------------------------------

def empty_state(shape: tuple[int, int], grid: tuple[int, int], dtype,
                tile_max_features: int, tile_max_candidates: int,
                device=None) -> TileBoundaryState:
    """An all-zeros :class:`TileBoundaryState` with the exact shapes
    :func:`tile_phase_ab` produces under these capacities — the scatter
    base for a cold delta run (every row is overwritten)."""
    tr, tc, n_tiles = _tile_dims(shape, grid)
    ring = len(_ring_coords(tr, tc)[0])
    k = min(tile_max_candidates, tr * tc)
    f = min(tile_max_features, tr * tc)

    def z(shape_, dt):
        return torch.zeros(shape_, dtype=dt, device=device)

    i32, b = torch.int32, torch.bool
    return TileBoundaryState(
        ring_gidx=z((n_tiles, ring), i32), ring_ptr=z((n_tiles, ring), i32),
        min_val=z((n_tiles,), dtype), min_gidx=z((n_tiles,), i32),
        e_val=z((n_tiles, k, 8), dtype), e_pos=z((n_tiles, k, 8), i32),
        e_a=z((n_tiles, k, 8), i32), e_b=z((n_tiles, k, 8), i32),
        e_ok=z((n_tiles, k, 8), b),
        root_val=z((n_tiles, f), dtype), root_gidx=z((n_tiles, f), i32),
        root_valid=z((n_tiles, f), b),
        rmax_val=z((n_tiles,), dtype), rmax_gidx=z((n_tiles,), i32),
        n_roots=z((n_tiles,), i32), n_cand=z((n_tiles,), i32))


def dirty_stacks(source, grid: tuple[int, int], dirty, bucket: int,
                 filtration: str = "superlevel", device=None
                 ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Halo-padded ``(bucket, tr+2, tc+2)`` value/gidx stacks of the dirty
    tiles on ``device``, plus their padded slot vector.

    Only dirty windows are staged (a host frame uploads O(dirty area); a
    :class:`StagedTiles` is indexed where it lies).  Padding repeats the
    *last* dirty tile (stack row and slot alike), so the scatter writes
    pad rows as exact duplicates of a real row.
    """
    dirty = np.asarray(dirty, np.int64)
    pad = bucket - len(dirty)
    if pad:
        dirty = np.concatenate([dirty, np.full(pad, dirty[-1])])
    with telemetry.span("delta.stage"):
        if isinstance(source, StagedTiles):
            shape = source.shape
            dev = source.pvals.device
            telemetry.readback(dev)     # a pageable upload
            pv = source.pvals[torch.as_tensor(dirty, device=dev)]
        else:
            arr = _host_frame(source)
            shape = tuple(arr.shape)
            dev = torch.device("cuda" if device is None else device)
            padded = _padded_host(arr, filtration)
            telemetry.readback(dev)     # a pageable upload
            pv = torch.stack([_window(padded, grid, int(t))
                              for t in dirty]).to(dev)
        pg = halo_gidx_stack(shape, grid, dirty, dev)
    return pv, pg, dirty


# ---------------------------------------------------------------------------
# Batched phase AB + scatter/seam-merge replay
# ---------------------------------------------------------------------------

def phase_ab_stack(pvals, pgidx, tv=None, *, merge_keys: str = "packed",
                   filtration: str = "superlevel",
                   tile_max_features: int, tile_max_candidates: int
                   ) -> TileBoundaryState:
    """Per-tile phases A+B over a (D, tr+2, tc+2) stack — the same stacked
    :func:`tile_phase_ab` the cold tiled path runs over all ``T`` tiles,
    applied to the dirty subset.  Tiles never mix in it, which is what
    makes the delta state bit-identical to a cold one, row for row.

    Under ``filtration='sublevel'`` the user-space stacks and threshold
    negate here; the returned state is in the *internal* superlevel order
    (diagrams only un-negate at :func:`scatter_merge`)."""
    packed_keys.check_finite(pvals, where="tile stacks", allow_inf=True)
    pvals = packed_keys.filtration_view(pvals, filtration)
    merge_keys = packed_keys.resolve_merge_keys(merge_keys, pvals.dtype)
    truncated, tvi = internal_threshold(tv, filtration, pvals.device)
    return tile_phase_ab(pvals, pgidx, tvi,
                         tile_max_candidates=tile_max_candidates,
                         tile_max_features=tile_max_features,
                         truncated=truncated, merge_keys=merge_keys)


def scatter_merge(state: TileBoundaryState, fresh: TileBoundaryState,
                  slots, tv=None, *, merge_keys: str = "packed",
                  filtration: str = "superlevel",
                  **kwargs) -> tuple[TileBoundaryState, TiledDiagram]:
    """Scatter fresh dirty-tile rows into a copy of the cached state and
    replay the O(boundary) seam merge.  Returns the updated full state
    (the next frame's cache entry; ``state`` itself is left as it was)
    and the :class:`TiledDiagram`.

    ``slots`` may repeat a slot (bucket padding repeats a real dirty slot
    with an identical fresh row), so the scatter writes the same bytes
    whatever order it lands in.  Both states are in the internal
    superlevel order; under sublevel the user-space threshold negates in
    and only the diagram negates out.  Other keyword arguments are those
    of :func:`merge_tile_state`.
    """
    merge_keys = packed_keys.resolve_merge_keys(merge_keys,
                                                state.root_val.dtype)
    dev = state.root_val.device
    truncated, tvi = internal_threshold(tv, filtration, dev)

    def put(c, f):
        out = c.clone()
        out[idx] = f
        return out

    with telemetry.span("delta.scatter", dev):
        telemetry.readback(dev)     # a pageable upload
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        new_state = TileBoundaryState(*(put(c, f)
                                        for c, f in zip(state, fresh)))
    td = merge_tile_state(new_state, tvi, truncated=truncated,
                          merge_keys=merge_keys, **kwargs)
    return new_state, negate_diagram(td, filtration)

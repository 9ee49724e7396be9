"""Tile-decomposed PixHomology: halo-tiled PH with a cross-tile seam merge.

Counterpart of ``repro.core.tiling``.  One image spans a ``(gr, gc)`` grid
of halo-padded tiles while staying **bit-identical** to whole-image
``pixhomology``:

1. *Per tile* (steps 1-4, memory ~ tile size): steepest-ascent pointers
   under the global ``(value, flat index)`` total order — the 1-pixel halo
   makes every owned pixel's 3x3 window exact; pointer-doubling label
   resolution *frozen at the halo*; exact candidates and clique-chained
   saddle edges on a per-tile key that is order-isomorphic to the global
   order (packed ``(value, global index)`` int64 keys, or per-tile dense
   ranks).
2. *Boundary condensation* (O(boundary)): the 1-px ring of every tile goes
   into a sorted (pixel -> exit pointer) table, and pointer doubling on
   that table resolves every cross-tile basin chain.
3. *Global seam merge*: per-tile basin roots and saddle edges form a
   compact elder-rule instance reduced by
   :func:`repro_torch.core.parallel_merge.boruvka_forest`, whose per-round
   reduction is the best-edge CUDA kernel on the card
   (``phase_c_impl="fused"``).

Where the reference vmaps one tile's program over the tiles, every tile
function here takes the whole stack with a leading tile axis ``T``: the
stencils shift the stack at once, pointer doubling gathers along each
tile's flat axis (one loop for the whole stack), and the top-k selections
run along the last axis (:func:`repro_torch.core.packed_keys.masked_top_k`),
each tile giving the bits the one-tile call would.  Phase A here is keyed
torch ops on global indices (:func:`keyed_steepest_pointers` +
:func:`resolve_labels`), as in the reference, not the phase-A kernel: the
kernel breaks ties by the tile's local index, which orders an
out-of-frame halo cell (index -1) differently against a pixel of equal
value on the bottom and right halos.

Residency: :func:`tiled_pixhomology` takes an ``(H, W)`` tensor;
:func:`tiled_pixhomology_stacks` takes the halo-padded stacks, which
:func:`load_tile_stacks` builds from a tile provider one tile at a time
into a preallocated device stack, so the host never holds more than one
halo tile of the image.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import telemetry
from repro_torch.core import packed_keys
from repro_torch.core.grid import (fixed_point_iterate, gather_flat,
                                   higher_neighbor_basins, neg_inf)
from repro_torch.core.packed_keys import key_pad, masked_top_k, pack_keys
from repro_torch.core.parallel_merge import boruvka_forest, chain_clique_edges
from repro_torch.core.pixhomology import (Diagram, exact_candidates,
                                          keyed_steepest_pointers,
                                          resolve_labels)

_I32_MAX = torch.iinfo(torch.int32).max


class TiledDiagram(NamedTuple):
    """Whole-image :class:`Diagram` plus the two-level overflow split."""

    diagram: Diagram
    tile_overflow: torch.Tensor    # () bool: some tile's F_t/K_t undersized
    merge_overflow: torch.Tensor   # () bool: global diagram capacity short
    n_tile_roots: torch.Tensor     # (T,) int32 roots per tile
    n_tile_cands: torch.Tensor     # (T,) int32 candidates per tile


class TileBoundaryState(NamedTuple):
    """Everything the seam merge needs, per tile — the cacheable artifact.

    Every field is **tile-local** (a function of one halo-padded tile's
    bytes), which is the delta-recompute contract
    (:mod:`repro_torch.core.delta`): saddle-edge endpoints ``e_a``/``e_b``
    carry *pre-labels* (an in-tile basin root or the halo pixel the ascent
    chain exits through), resolved to global basins only in
    :func:`merge_tile_state`.  Leading axis ``T`` (tiles):

    * ``ring_gidx``/``ring_ptr`` (T, R): the 1-px boundary ring and its
      exit pointers (the condensation-table rows);
    * ``e_*`` (T, k, 8): clique-chained saddle edges keyed by the saddle
      pixel (``e_val``/``e_pos``);
    * ``root_*`` (T, f): the top-``f`` owned basin roots; ``rmax_*`` the
      unfiltered per-tile maximum root (for the essential class);
    * ``n_roots``/``n_cand`` (T,): exact counts for overflow detection.
    """

    ring_gidx: torch.Tensor        # (T, R) int32
    ring_ptr: torch.Tensor         # (T, R) int32
    min_val: torch.Tensor          # (T,) image dtype
    min_gidx: torch.Tensor         # (T,) int32
    e_val: torch.Tensor            # (T, k, 8) image dtype
    e_pos: torch.Tensor            # (T, k, 8) int32
    e_a: torch.Tensor              # (T, k, 8) int32 pre-label endpoint
    e_b: torch.Tensor              # (T, k, 8) int32 pre-label endpoint
    e_ok: torch.Tensor             # (T, k, 8) bool
    root_val: torch.Tensor         # (T, f) image dtype
    root_gidx: torch.Tensor        # (T, f) int32
    root_valid: torch.Tensor       # (T, f) bool
    rmax_val: torch.Tensor         # (T,) image dtype
    rmax_gidx: torch.Tensor        # (T,) int32
    n_roots: torch.Tensor          # (T,) int32
    n_cand: torch.Tensor           # (T,) int32


# ---------------------------------------------------------------------------
# Grid selection / validation
# ---------------------------------------------------------------------------

def validate_grid(shape: tuple[int, int], grid: tuple[int, int]) -> None:
    h, w = shape
    gr, gc = grid
    if gr < 1 or gc < 1:
        raise ValueError(f"tile grid must be >= (1, 1), got {grid}")
    if h % gr or w % gc:
        raise ValueError(f"tile grid {grid} does not divide image {shape}; "
                         f"pick divisors (see choose_grid)")


def choose_grid(shape: tuple[int, int], max_tile_pixels: int
                ) -> tuple[int, int]:
    """Smallest dividing (gr, gc) whose tiles hold <= ``max_tile_pixels``.

    Prefers fewer tiles, then square-ish tiles.  Always solvable: (h, w)
    gives 1-pixel tiles.
    """
    h, w = shape

    def divisors(x):
        return [d for d in range(1, x + 1) if x % d == 0]

    best = None
    for gr in divisors(h):
        tr = h // gr
        for gc in divisors(w):
            tc = w // gc
            if tr * tc > max_tile_pixels:
                continue
            key = (gr * gc, abs(tr - tc), gr, gc)
            if best is None or key < best[0]:
                best = (key, (gr, gc))
            break   # larger gc only shrinks tiles further for this gr
    if best is None:   # max_tile_pixels < 1; degenerate, one pixel per tile
        return (h, w)
    return best[1]


def _ring_coords(tr: int, tc: int) -> tuple[np.ndarray, np.ndarray]:
    """Owned coordinates of the tile's 1-px boundary ring (static)."""
    rr, cc = np.mgrid[0:tr, 0:tc]
    mask = (rr == 0) | (rr == tr - 1) | (cc == 0) | (cc == tc - 1)
    return rr[mask], cc[mask]


def _interior_mask(ph: int, pw: int, device) -> torch.Tensor:
    m = torch.zeros((ph, pw), dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def _tile_dims(shape, grid) -> tuple[int, int, int]:
    (h, w), (gr, gc) = shape, grid
    return h // gr, w // gc, gr * gc


# ---------------------------------------------------------------------------
# Tile extraction
# ---------------------------------------------------------------------------

def split_tiles(arr2d: torch.Tensor, grid: tuple[int, int], fill
                ) -> torch.Tensor:
    """(H, W) -> (T, tr+2, tc+2) halo-padded tiles, row-major tile order."""
    h, w = arr2d.shape
    tr, tc, n_tiles = _tile_dims((h, w), grid)
    # Filled by torch.full, not F.pad (whose double fill would round an
    # int64 sentinel).
    padded = torch.full((h + 2, w + 2), fill, dtype=arr2d.dtype,
                        device=arr2d.device)
    padded[1:-1, 1:-1] = arr2d
    tiles = padded.unfold(0, tr + 2, tr).unfold(1, tc + 2, tc)
    return tiles.reshape(n_tiles, tr + 2, tc + 2)


def halo_gidx_stack(shape: tuple[int, int], grid: tuple[int, int],
                    tiles, device) -> torch.Tensor:
    """Global flat-index maps of the listed tiles' halo-padded windows,
    ``(len(tiles), tr+2, tc+2)`` int32 on ``device``, computed there
    arithmetically (never touching an (H, W) array); out-of-frame halo
    pixels are -1, matching ``split_tiles(gidx2d, grid, -1)``."""
    h, w = shape
    tr, tc, _ = _tile_dims(shape, grid)
    telemetry.readback(device)      # a pageable upload
    t = torch.as_tensor(np.asarray(tiles, np.int64), device=device)
    rows = ((t // grid[1]) * tr - 1)[:, None] + torch.arange(
        tr + 2, device=device)[None, :]
    cols = ((t % grid[1]) * tc - 1)[:, None] + torch.arange(
        tc + 2, device=device)[None, :]
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    gidx = rows[:, :, None] * w + cols[:, None, :]
    return torch.where(inside, gidx, -1).to(torch.int32)


def halo_gidx_tile(shape: tuple[int, int], grid: tuple[int, int],
                   t: int) -> np.ndarray:
    """:func:`halo_gidx_stack` of tile ``t`` alone, as a host array."""
    return halo_gidx_stack(shape, grid, [t], "cpu")[0].numpy()


@dataclasses.dataclass(frozen=True)
class StagedTiles:
    """Device-resident halo-padded tile stacks of one image.

    Built by :func:`load_tile_stacks` (tile-provider path, O(tile) host
    residency) and accepted by :func:`tiled_pixhomology_stacks` /
    :meth:`repro_torch.ph.PHEngine.run_tiled` in place of a host image.
    """

    pvals: Any                    # (T, tr+2, tc+2) image dtype
    pgidx: Any                    # (T, tr+2, tc+2) int32 global indices
    shape: tuple[int, int]        # full-image (H, W)
    grid: tuple[int, int]         # (gr, gc)


def load_tile_stacks(provider, grid: tuple[int, int], *, fill=None,
                     device=None) -> StagedTiles:
    """Stage a tile provider's halo-padded tiles on ``device`` (the CUDA
    device by default), one at a time.

    ``provider``: ``shape`` / ``dtype`` / ``halo_tile(t, grid, fill=...)``
    (e.g. :class:`repro_torch.data.astro.AstroImage`).  Each tile is copied
    into a preallocated ``(T, tr+2, tc+2)`` device stack as soon as it is
    generated, so the host holds one halo tile at a time and the device
    the image once.  ``fill`` overrides the halo fill value (the
    user-space inert extreme: ``+inf`` when the stacks will be consumed
    under the sublevel filtration; defaults to the superlevel ``-inf``).
    """
    h, w = provider.shape
    grid = tuple(grid)
    validate_grid((h, w), grid)
    tr, tc, n_tiles = _tile_dims((h, w), grid)
    dev = torch.device("cuda" if device is None else device)
    dtype = torch.from_numpy(np.empty(0, np.dtype(provider.dtype))).dtype
    if fill is None:
        fill = neg_inf(dtype)
    pvals = torch.empty((n_tiles, tr + 2, tc + 2), dtype=dtype, device=dev)
    for t in range(n_tiles):
        tile = np.asarray(provider.halo_tile(t, grid, fill=fill))
        pvals[t].copy_(torch.from_numpy(tile))
    pgidx = halo_gidx_stack((h, w), grid, range(n_tiles), dev)
    return StagedTiles(pvals, pgidx, (h, w), grid)


# ---------------------------------------------------------------------------
# Phase A (per tile): pointers + in-tile label resolution, frozen at halo
# ---------------------------------------------------------------------------

def tile_phase_a(pvals: torch.Tensor, pgidx: torch.Tensor):
    """Steps 1-2 on a ``(T, tr+2, tc+2)`` stack of halo-padded tiles.

    Pointers from :func:`keyed_steepest_pointers` keyed by *global* pixel
    index, then :func:`resolve_labels` pointer doubling with the halo
    frozen to itself (one doubling loop for the whole stack).  Returns
    ``(ptr_owned, ring_gidx, ring_ptr, min_val, min_gidx)``: per owned
    pixel the global index of its in-tile basin root *or* of the halo
    pixel its ascent chain exits through; the boundary-ring slice of that
    map; and each tile's (value, index)-minimum for the essential death.
    """
    n_tiles, ph, pw = pvals.shape
    tr, tc = ph - 2, pw - 2
    dev = pvals.device
    interior = _interior_mask(ph, pw, dev)
    flat = torch.arange(ph * pw, dtype=torch.int32,
                        device=dev).reshape(ph, pw)

    ptr_l = keyed_steepest_pointers(pvals, pgidx)
    m0 = torch.where(interior, ptr_l, flat).reshape(n_tiles, -1)
    m = resolve_labels(m0)
    resolved_g = gather_flat(pgidx.reshape(n_tiles, -1),
                             m).reshape(n_tiles, ph, pw)
    ptr_owned = resolved_g[:, 1:-1, 1:-1]

    own_vals = pvals[:, 1:-1, 1:-1]
    own_gidx = pgidx[:, 1:-1, 1:-1]
    ring = []
    for a in _ring_coords(tr, tc):
        telemetry.readback(dev)     # a pageable upload
        ring.append(torch.as_tensor(a, device=dev))
    rr, cc = ring
    ring_gidx = own_gidx[:, rr, cc]
    ring_ptr = ptr_owned[:, rr, cc]

    min_val = own_vals.amin(dim=(-2, -1))
    min_gidx = torch.where(own_vals == min_val[:, None, None], own_gidx,
                           _I32_MAX).amin(dim=(-2, -1))
    return ptr_owned, ring_gidx, ring_ptr, min_val, min_gidx


# ---------------------------------------------------------------------------
# Boundary condensation: sorted ring table + pointer doubling across tiles
# ---------------------------------------------------------------------------

def _table_follow(sg: torch.Tensor, sv: torch.Tensor, q: torch.Tensor
                  ) -> torch.Tensor:
    """values[q] where q is in the sorted-key table ``sg``, else q itself."""
    pos = torch.clamp(torch.searchsorted(sg, q.contiguous()), 0,
                      sg.shape[0] - 1)
    return torch.where(sg[pos] == q, sv[pos], q)


def resolve_ring_table(ring_gidx: torch.Tensor, ring_ptr: torch.Tensor):
    """Condensed cross-tile label resolution.

    ``ring_gidx``/``ring_ptr``: (T, R) per-tile boundary rings.  A basin
    chain can only leave a tile through a halo pixel, which is a ring
    pixel of the neighboring tile, so pointer doubling on this table alone
    resolves every cross-tile chain to its basin root.  Returns ``(sg,
    sl)``: sorted ring pixel ids and their final global basin labels.
    """
    rg = ring_gidx.reshape(-1)
    rp = ring_ptr.reshape(-1)
    order = torch.argsort(rg, stable=True)
    sg = rg[order].contiguous()
    sp = rp[order]
    sl, _ = fixed_point_iterate(lambda p: _table_follow(sg, p, p), sp)
    return sg, sl


# ---------------------------------------------------------------------------
# Phase B (per tile): pre-labels, exact candidates, seam/interior edges
# ---------------------------------------------------------------------------

def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` along the last axis (the last key is primary), by
    stable sorts from the least significant key up."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for k in keys[1:]:
        order = torch.gather(order, -1, torch.argsort(
            torch.gather(k, -1, order), dim=-1, stable=True))
    return order


def _dense_positions(order: torch.Tensor, values=None) -> torch.Tensor:
    """``out[..., order[..., i]] = values[..., i]`` (default: i), int32."""
    if values is None:
        values = torch.arange(order.shape[-1], dtype=torch.int32,
                              device=order.device).expand(order.shape)
    return torch.empty(order.shape, dtype=torch.int32,
                       device=order.device).scatter_(-1, order, values)


def tile_phase_b(pvals, pgidx, ptr_owned, tv, *,
                 tile_max_candidates: int, tile_max_features: int,
                 truncated: bool, merge_keys: str = "rank"):
    """Steps 3-4 on the tile stack, **label-independent** (tile-local).

    Returns per-tile compact pieces of the global merge instance:
    clique-chained saddle edges whose endpoints are *pre-labels*, the
    top-``tile_max_features`` basin roots, each tile's unfiltered maximum
    root, and candidate/root counts for overflow detection.  Equal
    pre-labels imply equal final labels; distinct pre-labels resolving to
    one basin only add self-loops the seam merge skips, and duplicate
    edges share their saddle pixel, hence their key — so the diagram is
    unchanged while the stage depends on nothing but each tile's bytes.

    ``merge_keys="packed"`` keys every comparison on the packed
    ``(value, global index)`` int64 key (globally order-isomorphic by
    construction); ``"rank"`` on per-tile dense ranks of the same order.
    """
    n_tiles, ph, pw = pvals.shape
    tr, tc = ph - 2, pw - 2
    n_loc = ph * pw
    dev = pvals.device
    interior = _interior_mask(ph, pw, dev)
    fill_v = neg_inf(pvals.dtype)

    own_vals = pvals[:, 1:-1, 1:-1]
    own_gidx = pgidx[:, 1:-1, 1:-1]

    # Pre-labels: owned pixels carry their in-tile resolution; halo pixels
    # stand for themselves; out-of-frame fill cells -1.
    plbl = torch.where(pgidx >= 0, pgidx, -1)
    plbl[:, 1:-1, 1:-1] = ptr_owned

    pv_flat = pvals.reshape(n_tiles, n_loc)
    pg_flat = pgidx.reshape(n_tiles, n_loc)
    if merge_keys == "packed":
        key = pack_keys(pv_flat, pg_flat)
    else:
        # Per-tile rank, order-isomorphic to the global (value, index)
        # order (halo fill keys (-inf, -1) sort below every real pixel).
        key = _dense_positions(_lexsort((pg_flat, pv_flat)))
    pad = key_pad(key.dtype)

    cand2d = exact_candidates(key.reshape(n_tiles, ph, pw), plbl) & interior
    if truncated:
        cand2d &= pvals >= tv
    cand_flat = cand2d.reshape(n_tiles, n_loc)
    n_cand = cand_flat.sum(dim=-1, dtype=torch.int32)

    k = min(tile_max_candidates, tr * tc)
    top_keys, top_loc = masked_top_k(key, cand_flat, k)
    valid = top_keys > pad
    ok, lbl = higher_neighbor_basins(top_loc, top_keys, key,
                                     plbl.reshape(n_tiles, n_loc), (ph, pw),
                                     valid)
    edge_ok, prev_lbl = chain_clique_edges(ok, lbl)          # (T, k, 8)
    e_val = gather_flat(pv_flat, top_loc)[..., None].expand(ok.shape)
    e_pos = gather_flat(pg_flat, top_loc)[..., None].expand(ok.shape)
    e_a = torch.where(edge_ok, lbl, 0)
    e_b = torch.where(edge_ok, prev_lbl, 0)

    # Root-ness is tile-local: ascent chains strictly increase, so a pixel
    # whose chain leaves the tile never resolves back to itself.
    root_mask = ptr_owned == own_gidx
    # Unfiltered per-tile maximum root: the global maximum pixel is always
    # a root, so the reduce over tiles finds the essential class even when
    # a threshold filters the listed roots.
    rmax_val = torch.where(root_mask, own_vals, fill_v).amax(dim=(-2, -1))
    rmax_gidx = torch.where(root_mask & (own_vals == rmax_val[:, None, None]),
                            own_gidx, -1).amax(dim=(-2, -1))
    if truncated:
        root_mask &= own_vals >= tv
    n_roots = root_mask.sum(dim=(-2, -1), dtype=torch.int32)

    f = min(tile_max_features, tr * tc)
    own_key = key.reshape(n_tiles, ph, pw)[:, 1:-1, 1:-1].reshape(
        n_tiles, -1)
    top_rk, top_ri = masked_top_k(own_key, root_mask.reshape(n_tiles, -1), f)
    rvalid = top_rk > pad
    root_gidx = torch.where(rvalid, gather_flat(own_gidx.reshape(
        n_tiles, -1), top_ri), -1).to(torch.int32)
    root_val = torch.where(rvalid, gather_flat(own_vals.reshape(
        n_tiles, -1), top_ri), fill_v)

    return (e_val.contiguous(), e_pos.contiguous(), e_a, e_b, edge_ok,
            root_val, root_gidx, rvalid, rmax_val, rmax_gidx, n_roots,
            n_cand)


def tile_phase_ab(pvals, pgidx, tv, *,
                  tile_max_candidates: int, tile_max_features: int,
                  truncated: bool, merge_keys: str = "rank"
                  ) -> TileBoundaryState:
    """Phases A+B on a tile stack -> its :class:`TileBoundaryState`.

    Row ``t`` of the result is a pure function of tile ``t``'s bytes (plus
    the static capacities and threshold): the unit the delta layer caches
    and replays.  The cold path runs it over all ``T`` tiles, a delta run
    over the dirty subset.  A ``tiles.phase_ab`` span on the stack's
    device.
    """
    with telemetry.span("tiles.phase_ab", pvals.device):
        (ptr_owned, ring_gidx, ring_ptr, min_val,
         min_gidx) = tile_phase_a(pvals, pgidx)
        (e_val, e_pos, e_a, e_b, e_ok, root_val, root_gidx, root_valid,
         rmax_val, rmax_gidx, n_roots, n_cand) = tile_phase_b(
            pvals, pgidx, ptr_owned, tv,
            tile_max_candidates=tile_max_candidates,
            tile_max_features=tile_max_features,
            truncated=truncated, merge_keys=merge_keys)
    return TileBoundaryState(ring_gidx, ring_ptr, min_val, min_gidx,
                             e_val, e_pos, e_a, e_b, e_ok,
                             root_val, root_gidx, root_valid,
                             rmax_val, rmax_gidx, n_roots, n_cand)


# ---------------------------------------------------------------------------
# Global seam merge on the compact (basin, saddle-edge) instance
# ---------------------------------------------------------------------------

def _slot_lookup(sorted_key, slot_of, q):
    """(slot, found) of global root ids in the compact root table (slot
    -1 where absent)."""
    pos = torch.clamp(torch.searchsorted(sorted_key, q.contiguous()), 0,
                      sorted_key.shape[0] - 1)
    found = sorted_key[pos] == q
    return torch.where(found, slot_of[pos], -1), found


def seam_merge(root_val, root_gidx, root_valid,
               e_val, e_pos, e_a, e_b, e_valid,
               rmax_val, rmax_gidx, gmin_val, gmin_gidx,
               tv, *, truncated: bool, max_features: int, dtype,
               merge_keys: str = "rank", phase_c_impl: str = "fused",
               phase_c_block: int = 1024, use_pallas: bool | None = None):
    """Elder-rule reduction of the concatenated per-tile instances.

    Vertices are the listed basin roots; edges reference roots by global
    pixel id through a sorted lookup table.  The reduction is
    :func:`repro_torch.core.parallel_merge.boruvka_forest`;
    ``phase_c_impl="fused"`` makes its per-round reduction
    :func:`repro_torch.kernels.ph_phase_c.ops.best_edge_reduce` (the CUDA
    kernel on CUDA tensors unless ``use_pallas`` is False, the plain
    version on CPU tensors), ``"xla"`` the plain version — bitwise equal
    either way.  ``phase_c_block`` is the TPU kernel's edge block and has
    no meaning here.  Returns ``(birth, death, p_birth, p_death, count,
    n_unmerged, merge_overflow)``.
    """
    del phase_c_block
    rv = root_val.reshape(-1)
    rg = root_gidx.reshape(-1)
    ok_r = root_valid.reshape(-1)
    nv = rv.shape[0]
    dev = rv.device
    neg = neg_inf(dtype)

    # Root id -> compact slot (sorted table; invalid slots key to int-max).
    key_g = torch.where(ok_r, rg, _I32_MAX)
    order_g = torch.argsort(key_g, stable=True).to(torch.int32)
    sorted_g = key_g[order_g.long()].contiguous()

    ev = e_val.reshape(-1)
    ep = e_pos.reshape(-1)
    sa, fa = _slot_lookup(sorted_g, order_g, e_a.reshape(-1))
    sb, fb = _slot_lookup(sorted_g, order_g, e_b.reshape(-1))
    alive = e_valid.reshape(-1) & fa & fb   # missing endpoint: tile overflow

    if merge_keys == "packed":
        # Packed (value, global index) keys: order-isomorphic with no sort,
        # equal exactly when the saddle pixel coincides.
        i64_pad = key_pad(torch.int64)
        v_rank = torch.where(ok_r, pack_keys(rv, rg), i64_pad)
        e_rank = torch.where(alive, pack_keys(ev, ep), i64_pad)
    else:
        # Vertex birth keys: rank of (value, global index) among valid
        # roots.
        vorder = _lexsort((rg, rv, ok_r.to(torch.int32)))
        v_rank = torch.where(ok_r, _dense_positions(vorder),
                             key_pad(torch.int32))
        # Edge saddle keys: dense rank of (value, global index), EQUAL for
        # edges sharing a saddle pixel (the Boruvka tie rule depends on it).
        akey = alive.to(torch.int32)
        eorder = _lexsort((ep, ev, akey))
        s_ak, s_ev, s_ep = akey[eorder], ev[eorder], ep[eorder]
        new_grp = torch.cat([
            torch.ones(1, dtype=torch.bool, device=dev),
            (s_ak[1:] != s_ak[:-1]) | (s_ev[1:] != s_ev[:-1])
            | (s_ep[1:] != s_ep[:-1])])
        grp = torch.cumsum(new_grp.to(torch.int32), 0,
                           dtype=torch.int32) - 1
        e_rank = torch.where(alive, _dense_positions(eorder, grp),
                             key_pad(torch.int32))

    reduce_fn = None
    if phase_c_impl == "fused":
        from repro_torch.kernels.ph_phase_c import ops as phase_c_ops
        reduce_fn = functools.partial(phase_c_ops.best_edge_reduce,
                                      use_pallas=use_pallas)
    telemetry.readback()
    n_live = int(ok_r.sum())
    dval, dpos, _rounds = boruvka_forest(
        v_rank, e_rank, ev.to(dtype), ep,
        torch.clamp(sa, min=0), torch.clamp(sb, min=0),
        n_live=n_live, reduce_fn=reduce_fn)

    if truncated:
        # Survivors that never merged above the threshold die at it
        # (p_death stays -1, matching the whole-image semantics).
        undied = ok_r & (dpos < 0)
        dval = torch.where(undied, torch.as_tensor(tv, device=dev).to(dtype),
                           dval)

    # Essential class: the globally maximal root dies at the global minimum.
    gmax_val = rmax_val.max()
    gmax_gidx = torch.where(rmax_val == gmax_val, rmax_gidx, -1).max()
    eslot, efound = _slot_lookup(sorted_g, order_g, gmax_gidx.view(1))
    es = torch.clamp(eslot, min=0).long()
    dval = dval.index_put((es,), torch.where(efound, gmin_val.to(dtype),
                                             dval[es]))
    dpos = dpos.index_put((es,), torch.where(efound, gmin_gidx, dpos[es]))

    # Diagram rows, descending (birth value, birth index); ``v_rank`` is
    # pad-keyed on invalid slots, so one top-k serves both key paths.
    c = ok_r.sum(dtype=torch.int32)
    f = max_features
    kk = min(f, nv)
    _, top_slot = torch.topk(v_rank, kk)
    row_valid = torch.arange(kk, device=dev) < c

    def rows(src, fill, dt):
        out = torch.full((f,), fill, dtype=dt, device=dev)
        out[:kk] = torch.where(row_valid, src[top_slot], fill)
        return out

    birth = rows(rv.to(dtype), neg, dtype)
    death = rows(dval, neg, dtype)
    p_birth = rows(rg, -1, torch.int32)
    p_death = rows(dpos, -1, torch.int32)
    n_unmerged = (ok_r & (dpos < 0)).sum(dtype=torch.int32)
    merge_overflow = c > f
    return (birth, death, p_birth, p_death, torch.clamp(c, max=f),
            n_unmerged, merge_overflow)


def merge_tile_state(state: TileBoundaryState, tv, *,
                     shape: tuple[int, int], grid: tuple[int, int],
                     max_features: int, tile_max_features: int,
                     tile_max_candidates: int, truncated: bool,
                     merge_keys: str = "rank", phase_c_impl: str = "fused",
                     phase_c_block: int = 1024,
                     use_pallas: bool | None = None) -> TiledDiagram:
    """O(boundary) global replay: ring condensation + pre-label resolution
    + elder-rule seam merge over a stacked :class:`TileBoundaryState`.

    The only stage that mixes tiles; it never touches pixels.  Pointer
    doubling on the full ring table re-resolves every cross-tile chain
    (clean rows of a delta run store pre-labels, not stale final labels),
    then ``e_a``/``e_b`` map through the table; a pre-label absent from it
    is an in-tile root, whose final label is itself.  The ring table and
    the seam merge are ``tiles.ring_table`` and ``tiles.seam_merge`` spans
    on the state's device.
    """
    h, w = shape
    tr, tc, _ = _tile_dims(shape, grid)
    dev = state.root_val.device

    with telemetry.span("tiles.ring_table", dev):
        sg, sl = resolve_ring_table(state.ring_gidx, state.ring_ptr)

    gmin_val = state.min_val.min()
    gmin_gidx = torch.where(state.min_val == gmin_val, state.min_gidx,
                            _I32_MAX).min()

    e_a = _table_follow(sg, sl, state.e_a)
    e_b = _table_follow(sg, sl, state.e_b)

    f_global = min(max_features, h * w)
    with telemetry.span("tiles.seam_merge", dev):
        (birth, death, p_birth, p_death, count, n_unmerged,
         merge_overflow) = seam_merge(
            state.root_val, state.root_gidx, state.root_valid,
            state.e_val, state.e_pos, e_a, e_b, state.e_ok,
            state.rmax_val, state.rmax_gidx, gmin_val, gmin_gidx, tv,
            truncated=truncated, max_features=f_global,
            dtype=state.root_val.dtype, merge_keys=merge_keys,
            phase_c_impl=phase_c_impl, phase_c_block=phase_c_block,
            use_pallas=use_pallas)

    tile_overflow = (
        (state.n_cand > min(tile_max_candidates, tr * tc)).any()
        | (state.n_roots > min(tile_max_features, tr * tc)).any())
    diagram = Diagram(birth, death, p_birth, p_death, count, n_unmerged,
                      tile_overflow | merge_overflow)
    return TiledDiagram(diagram, tile_overflow, merge_overflow,
                        state.n_roots, state.n_cand)


# ---------------------------------------------------------------------------
# Full tiled algorithm
# ---------------------------------------------------------------------------

def internal_threshold(truncate_value, filtration: str, device):
    """``(truncated, tv)``: the user-space threshold mapped into the
    internal superlevel order as a 0-d tensor (``-inf`` float32 when there
    is none)."""
    if truncate_value is None:
        return False, torch.tensor(float("-inf"), device=device)
    tv = torch.as_tensor(truncate_value, device=device)
    return True, (-tv if filtration == "sublevel" else tv)


def negate_diagram(td: TiledDiagram, filtration: str) -> TiledDiagram:
    """Map a diagram from the internal superlevel order back to user
    space (a no-op under superlevel)."""
    if filtration != "sublevel":
        return td
    d = td.diagram
    return td._replace(diagram=d._replace(birth=-d.birth, death=-d.death))


def tiled_pixhomology(image: torch.Tensor, truncate_value=None, *,
                      grid: tuple[int, int], merge_keys: str = "packed",
                      filtration: str = "superlevel",
                      **kwargs) -> TiledDiagram:
    """0-dim PH of one 2D image via halo-tiled decomposition (bit-identical
    to ``pixhomology(image, truncate_value, candidate_mode="exact")``).

    ``grid``: (gr, gc) tile grid; must divide the image shape
    (:func:`choose_grid` picks one from a tile-pixel budget).  The halo
    fill stays in user space (``+inf`` under sublevel; the stacks core
    owns the negation).  Other keyword arguments are those of
    :func:`tiled_pixhomology_stacks`.
    """
    if image.dim() != 2:
        raise ValueError(f"expected 2D image, got shape {tuple(image.shape)}")
    h, w = image.shape
    grid = tuple(grid)
    validate_grid((h, w), grid)
    fill = neg_inf(image.dtype)
    if filtration == "sublevel":
        fill = -fill
    with telemetry.span("tiles.split", image.device):
        pvals = split_tiles(image, grid, fill)
        pgidx = halo_gidx_stack((h, w), grid,
                                np.arange(grid[0] * grid[1]), image.device)
    return tiled_pixhomology_stacks(
        pvals, pgidx, truncate_value, shape=(h, w), grid=grid,
        merge_keys=merge_keys, filtration=filtration, **kwargs)


def tiled_pixhomology_stacks(pvals: torch.Tensor, pgidx: torch.Tensor,
                             truncate_value=None, *,
                             shape: tuple[int, int], grid: tuple[int, int],
                             max_features: int = 8192,
                             tile_max_features: int = 2048,
                             tile_max_candidates: int = 8192,
                             merge_keys: str = "packed",
                             phase_c_impl: str = "fused",
                             phase_c_block: int = 1024,
                             filtration: str = "superlevel",
                             use_pallas: bool | None = None
                             ) -> TiledDiagram:
    """Halo-tiled PH on pre-staged tile stacks (the streaming entry point).

    ``pvals``/``pgidx``: (T, tr+2, tc+2) halo-padded value / global-index
    stacks in row-major tile order — what :func:`split_tiles` produces
    from a whole image, or :func:`load_tile_stacks` from a tile provider.
    ``merge_keys`` resolves as in ``pixhomology`` (packed int64 keys for
    every dtype of 32 bits or fewer).  Sublevel runs on the exact
    negation: the stacks (user space, ``+inf`` halo fill) and threshold
    negate here, every internal stage stays in superlevel order, and only
    the output diagram negates back.
    """
    h, w = shape
    grid = tuple(grid)
    validate_grid((h, w), grid)
    tr, tc, n_tiles = _tile_dims((h, w), grid)
    if tuple(pvals.shape) != (n_tiles, tr + 2, tc + 2):
        raise ValueError(f"tile stack shape {tuple(pvals.shape)} does not "
                         f"match image {shape} under grid {grid}")
    packed_keys.check_finite(pvals, where="tile stacks", allow_inf=True)
    merge_keys = packed_keys.resolve_merge_keys(merge_keys, pvals.dtype)
    pvals = packed_keys.filtration_view(pvals, filtration)
    truncated, tv = internal_threshold(truncate_value, filtration,
                                       pvals.device)
    state = tile_phase_ab(pvals, pgidx, tv,
                          tile_max_candidates=tile_max_candidates,
                          tile_max_features=tile_max_features,
                          truncated=truncated, merge_keys=merge_keys)
    td = merge_tile_state(
        state, tv, shape=(h, w), grid=grid, max_features=max_features,
        tile_max_features=tile_max_features,
        tile_max_candidates=tile_max_candidates, truncated=truncated,
        merge_keys=merge_keys, phase_c_impl=phase_c_impl,
        phase_c_block=phase_c_block, use_pallas=use_pallas)
    return negate_diagram(td, filtration)


# ---------------------------------------------------------------------------
# Per-tile cost model (the grid autotuner's footprint source)
# ---------------------------------------------------------------------------

class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops allocate while active and that
    are still alive, and their peak after each op.  An output whose
    storage is one of the op's inputs (an in-place result or a view)
    allocates nothing; a storage leaves the count when it is freed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr()
                for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            nbytes = storage.nbytes()
            if nbytes and storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                self.live += nbytes
                weakref.finalize(storage, self._free, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _footprint(fn, args) -> tuple[Any, dict]:
    """Run ``fn(*args)`` and report the reference's four memory fields."""
    arg_bytes = _tensor_bytes(args)
    with _LiveBytes() as count:
        out = fn(*args)
    out_bytes = _tensor_bytes(out)
    temp = max(0, count.peak - out_bytes)
    return out, {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                 "temp_bytes": temp,
                 "peak_bytes_est": arg_bytes + out_bytes + temp}


def per_tile_cost(tile_shape: tuple[int, int], dtype, n_tiles: int,
                  tile_max_features: int = 2048,
                  tile_max_candidates: int = 8192,
                  merge_keys: str = "packed", *, device=None) -> dict:
    """Run the per-tile phases on a stack of one worst-case tile and
    report their memory footprint (the reference's keys).

    The tile is the stride-2 peak grid (the most roots and candidates a
    tile can hold) with an out-of-frame halo, on ``device`` (the CUDA
    device by default).  Everything here scales with the *tile* shape
    (plus the O(boundary) condensation table), never with the image.  Per
    phase, ``argument_bytes`` and ``output_bytes`` are the sizes of its
    input and output tensors, and ``temp_bytes`` the peak of the bytes it
    holds beyond its outputs: the storages its ops allocate and have not
    freed yet, counted after each op by a dispatch mode on either device
    (so the count does not depend on the caching allocator's state; an
    op's internal workspace is not seen).  ``peak_bytes_est`` is their
    sum.
    """
    from repro_torch.roofline.autotune import peak_grid, dtype_name

    tr, tc = int(tile_shape[0]), int(tile_shape[1])
    dev = torch.device("cuda" if device is None else device)
    pv = peak_grid((tr, tc), dtype_name(dtype), dev)
    merge_keys = packed_keys.resolve_merge_keys(merge_keys, pv.dtype)
    pv = split_tiles(pv, (1, 1), neg_inf(pv.dtype))
    pg = halo_gidx_stack((tr, tc), (1, 1), [0], dev)
    tv = torch.tensor(float("-inf"), device=dev)
    ring = len(_ring_coords(tr, tc)[0])
    out: dict = {"tile_shape": [tr, tc], "ring_pixels": ring,
                 "table_entries": n_tiles * ring, "merge_keys": merge_keys}
    a_out, out["phase_a"] = _footprint(tile_phase_a, (pv, pg))
    _, out["phase_b"] = _footprint(functools.partial(
        tile_phase_b, tile_max_candidates=tile_max_candidates,
        tile_max_features=tile_max_features, truncated=True,
        merge_keys=merge_keys), (pv, pg, a_out[0], tv))
    return out

"""PixHomology: 0-dimensional persistent homology of 2D images (PyTorch).

Counterpart of ``repro.core.pixhomology`` for the whole-image path.
Superlevel-set filtration: components are born at local maxima and die
when they merge into a component with an older (larger) birth (elder
rule); the essential class of the global maximum dies at the global
minimum.  The computation is the same three-stage graph:

* **Phase A** (:func:`phase_a`) — ``"fused"``: steepest-ascent pointers
  snapped inside ``strip_rows``-row strips plus the strictly-higher
  8-neighbor bitmask, through :mod:`repro_torch.kernels.ph_phase_a`;
  ``"pooled"``: the paper's ``arg-maxpool2d`` pointers (line 1), through
  :mod:`repro_torch.kernels.maxpool` (the CUDA kernels on the card, their
  plain versions on the CPU).
* **Phase B** (:func:`phase_b`) — label resolution by pointer doubling on
  the compacted strip-boundary frontier (fused) or the whole image
  (pooled).
* **Candidates** — ``candidate_mode="exact"``: pixels whose strictly
  higher neighbors span two basins; ``"paper"``: the paper's component
  edges (``maxpool2d(M) != -maxpool2d(-M)``, line 6) distilled to local
  minima and axis saddles.
* **Phase C** (:func:`phase_c`) — the sequential elder-rule sweep
  (``merge_impl="scan"``) or the parallel Boruvka forest (``"boruvka"``;
  ``phase_c_impl="fused"`` runs it on the compacted root instance with the
  :mod:`repro_torch.kernels.ph_phase_c` best-edge kernel), the essential
  class, and the fixed-capacity diagram.

Every comparison keys on an order-isomorphic encoding of the strict
``(value, flat_index)`` total order: packed int64 keys (default) or dense
int32 ranks; both give the same bits.  All capacities are static and the
diagram carries an overflow flag the engine regrows on.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import packed_keys
from repro_torch.core.grid import (NEIGHBOR_OFFSETS, fixed_point_iterate,
                                   gather_flat, higher_neighbor_basins,
                                   neg_inf, shift2d)
from repro_torch.core.packed_keys import key_pad, key_top, masked_top_k
from repro_torch.kernels.maxpool import ops as pool_ops
from repro_torch.kernels.ph_phase_a import ops as phase_a_ops


class Diagram(NamedTuple):
    """Fixed-capacity persistence diagram (padded)."""

    birth: torch.Tensor       # (F,) image dtype, descending; padding = -inf
    death: torch.Tensor       # (F,) image dtype; -inf for padding/unmerged
    p_birth: torch.Tensor     # (F,) int32 flat pixel index of the maximum
    p_death: torch.Tensor     # (F,) int32 flat pixel index of the saddle
    count: torch.Tensor       # () int32 number of valid rows
    n_unmerged: torch.Tensor  # () int32 roots that never died
    overflow: torch.Tensor    # () bool: capacity exceeded -> regrow


class PhaseA(NamedTuple):
    """Phase-A artifacts (flat): pointers and, from the fused stage only,
    the higher-neighbor bitmask (``None`` from the pooled stage)."""

    pointers: torch.Tensor
    hi_mask: torch.Tensor | None


def diagram_to_numpy(d: Diagram) -> Diagram:
    """The diagram's fields as host numpy arrays (bfloat16 widens exactly
    to float32, which numpy can hold)."""
    def host(t):
        telemetry.readback(t.device)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return Diagram(*(host(t) for t in d))


def diagram_from_numpy(fields, device=None,
                       value_dtype: torch.dtype | None = None) -> Diagram:
    """Build a :class:`Diagram` of tensors from numpy arrays given in
    ``Diagram`` field order (any sequence or NamedTuple of seven arrays).
    ``value_dtype`` casts births and deaths (e.g. back to bfloat16)."""
    ts = [torch.as_tensor(np.array(f), device=device) for f in fields]
    if value_dtype is not None:
        ts[0], ts[1] = ts[0].to(value_dtype), ts[1].to(value_dtype)
    return Diagram(*ts)


# ---------------------------------------------------------------------------
# Total order helpers
# ---------------------------------------------------------------------------

def total_order_rank(values_flat: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of pixel i in the ascending (value, index) order."""
    n = values_flat.shape[0]
    perm = torch.argsort(values_flat, stable=True)   # ties -> ascending index
    rank = torch.zeros(n, dtype=torch.int32, device=values_flat.device)
    rank[perm] = torch.arange(n, dtype=torch.int32, device=values_flat.device)
    return rank


def total_order_keys(values_flat: torch.Tensor,
                     merge_keys: str) -> torch.Tensor:
    """Phase-C merge keys: packed int64 bit-keys or dense int32 ranks."""
    if merge_keys == "packed":
        return packed_keys.pack_keys(values_flat)
    if merge_keys == "rank":
        return total_order_rank(values_flat)
    raise ValueError(f"unknown merge_keys {merge_keys!r}")


# ---------------------------------------------------------------------------
# Phase A / phase B
# ---------------------------------------------------------------------------

def steepest_neighbors(image: torch.Tensor, *,
                       use_pallas: bool | None = None) -> torch.Tensor:
    """arg-maxpool2d(I): flat index of each pixel's 3x3 max (paper line 1),
    flattened over the last two axes."""
    _, arg = pool_ops.maxargmaxpool3x3(image, use_pallas=use_pallas)
    return arg.reshape(*image.shape[:-2], -1)


def keyed_steepest_pointers(values2d: torch.Tensor,
                            keys2d: torch.Tensor) -> torch.Tensor:
    """Steepest-ascent pointer (local flat id) under the (value, key) total
    order; self included.  Fill cells (key -1, value -inf) never win.

    The tiled path instantiates this with *global* pixel indices as keys
    on a stack of halo-padded tiles (leading axes are batch axes), so the
    per-tile order is isomorphic to the global one.
    """
    h, w = values2d.shape[-2:]
    flat = torch.arange(h * w, dtype=torch.int32,
                        device=values2d.device).reshape(h, w)
    fill_v = neg_inf(values2d.dtype)
    best_v, best_k, best_l = values2d, keys2d, flat
    for dr, dc in NEIGHBOR_OFFSETS:
        v = shift2d(values2d, dr, dc, fill_v)
        k = shift2d(keys2d, dr, dc, -1)
        lo = shift2d(flat, dr, dc, -1)
        better = (v > best_v) | ((v == best_v) & (k > best_k))
        best_v = torch.where(better, v, best_v)
        best_k = torch.where(better, k, best_k)
        best_l = torch.where(better, lo, best_l)
    return best_l


def phase_a(image: torch.Tensor, *, phase_a_impl: str = "fused",
            strip_rows: int = 8, use_pallas: bool | None = None) -> PhaseA:
    """Stage A ((H, W) image or (B, H, W) batch): ``"fused"`` gives
    strip-snapped pointers + the higher-neighbor bitmask; ``"pooled"`` the
    raw arg-maxpool pointers (paper line 1) and no bitmask."""
    if phase_a_impl == "fused":
        ptr, hi_mask = phase_a_ops.fused_phase_a(
            image, strip_rows=strip_rows, use_pallas=use_pallas)
        return PhaseA(ptr, hi_mask)
    if phase_a_impl == "pooled":
        return PhaseA(steepest_neighbors(image, use_pallas=use_pallas), None)
    raise ValueError(f"unknown phase_a_impl {phase_a_impl!r}")


def resolve_labels(pointers: torch.Tensor, *, with_count: bool = False):
    """Pointer-double ``M = M[M]`` to a fixed point (dense)."""
    m, count = fixed_point_iterate(lambda q: gather_flat(q, q), pointers)
    return (m, count) if with_count else m


def resolve_labels_frontier(pointers: torch.Tensor, shape: tuple[int, int],
                            strip_rows: int, *, with_count: bool = False):
    """Label resolution on the compacted strip-boundary frontier.

    ``pointers`` must be strip-snapped (fused phase A): every entry is a
    basin root or a pixel in a boundary row, so doubling runs on the
    boundary-row table alone and one final gather extends it to every
    pixel.  Bitwise equal to :func:`resolve_labels`.
    """
    h, w = shape
    dev = pointers.device
    telemetry.readback(dev)     # a pageable upload
    b_rows = torch.as_tensor(phase_a_ops.boundary_rows(h, strip_rows),
                             device=dev)
    row_slot = torch.full((h,), -1, dtype=torch.int32, device=dev)
    row_slot[b_rows.long()] = torch.arange(b_rows.shape[0], dtype=torch.int32,
                                           device=dev)
    b_flat = (b_rows[:, None] * w + torch.arange(
        w, dtype=torch.int32, device=dev)[None, :]).reshape(-1)

    def follow(table, q):
        rs = row_slot[(q // w).long()]
        slot = rs * w + q % w
        return torch.where(rs >= 0, table[torch.clamp(slot, min=0).long()], q)

    p0 = pointers[b_flat.long()]
    table, count = fixed_point_iterate(lambda p: follow(p, p), p0)
    labels = follow(table, pointers)
    return (labels, count) if with_count else labels


def phase_b(pa: PhaseA, shape: tuple[int, int], *,
            phase_a_impl: str = "fused", strip_rows: int = 8) -> torch.Tensor:
    """Stage B: basin labels from phase-A pointers."""
    if phase_a_impl == "fused":
        return resolve_labels_frontier(pa.pointers, shape, strip_rows)
    return resolve_labels(pa.pointers)


# ---------------------------------------------------------------------------
# Steps 3-4: candidate death points
# ---------------------------------------------------------------------------

def exact_candidates(key2d: torch.Tensor,
                     labels2d: torch.Tensor) -> torch.Tensor:
    """Pixels whose strictly-higher 8-neighbors span >= 2 distinct basins
    (from any order-isomorphic key image)."""
    no_lbl = torch.iinfo(torch.int32).max
    fill = key_pad(key2d.dtype)
    hi_max = torch.full(key2d.shape, -1, dtype=torch.int32,
                        device=key2d.device)
    hi_min = torch.full(key2d.shape, no_lbl, dtype=torch.int32,
                        device=key2d.device)
    for dr, dc in NEIGHBOR_OFFSETS:
        nkey = shift2d(key2d, dr, dc, fill)
        nlbl = shift2d(labels2d, dr, dc, -1)
        higher = nkey > key2d
        hi_max = torch.where(higher, torch.maximum(hi_max, nlbl), hi_max)
        hi_min = torch.where(higher, torch.minimum(hi_min, nlbl), hi_min)
    return (hi_max >= 0) & (hi_max != hi_min)


def exact_candidates_masked(hi_mask2d: torch.Tensor,
                            labels2d: torch.Tensor) -> torch.Tensor:
    """:func:`exact_candidates` from phase A's higher-neighbor bitmask."""
    no_lbl = torch.iinfo(torch.int32).max
    hi_max = torch.full(hi_mask2d.shape, -1, dtype=torch.int32,
                        device=hi_mask2d.device)
    hi_min = torch.full(hi_mask2d.shape, no_lbl, dtype=torch.int32,
                        device=hi_mask2d.device)
    for j, (dr, dc) in enumerate(NEIGHBOR_OFFSETS):
        nlbl = shift2d(labels2d, dr, dc, -1)
        higher = ((hi_mask2d >> j) & 1) == 1
        hi_max = torch.where(higher, torch.maximum(hi_max, nlbl), hi_max)
        hi_min = torch.where(higher, torch.minimum(hi_min, nlbl), hi_min)
    return (hi_max >= 0) & (hi_max != hi_min)


def paper_candidates(key2d: torch.Tensor, comp2d: torch.Tensor, *,
                     use_pallas: bool | None = None) -> torch.Tensor:
    """Paper-literal steps 3-4: component edges, then min/saddle
    distillation.

    comp2d: re-indexed component image (incremental ids, paper step 2).
    Edge:   maxpool2d(M) != -maxpool2d(-M)           (paper line 6)
    Keep:   local minima or axis saddles of I        (paper "distillation")
    """
    edge = (pool_ops.maxpool3x3(comp2d, use_pallas=use_pallas)
            != pool_ops.minpool3x3(comp2d, use_pallas=use_pallas))

    # Directional fills: for "min along" tests a missing neighbor counts as
    # higher (dtype max), for "max along" as lower (dtype min); valid keys
    # never reach either sentinel.
    hi, lo = key_top(key2d.dtype), key_pad(key2d.dtype)

    def nb(dr, dc, fill):
        return shift2d(key2d, dr, dc, fill)

    local_min = torch.ones(key2d.shape, dtype=torch.bool,
                           device=key2d.device)
    for dr, dc in NEIGHBOR_OFFSETS:
        local_min &= nb(dr, dc, hi) > key2d

    axes = [(0, 1), (1, 0), (1, 1), (1, -1)]
    min_along = [(nb(dr, dc, hi) > key2d) & (nb(-dr, -dc, hi) > key2d)
                 for dr, dc in axes]
    max_along = [(nb(dr, dc, lo) < key2d) & (nb(-dr, -dc, lo) < key2d)
                 for dr, dc in axes]
    saddle = torch.zeros(key2d.shape, dtype=torch.bool, device=key2d.device)
    for a in range(len(axes)):
        for b in range(len(axes)):
            if a != b:
                saddle |= min_along[a] & max_along[b]
    return edge & (local_min | saddle)


def reindex_components(key_flat: torch.Tensor, labels_flat: torch.Tensor,
                       is_root: torch.Tensor) -> torch.Tensor:
    """Paper step 2 re-indexing: component ids 0..C-1 ascending by birth.

    Returns the int32 component id of every pixel; id C-1 is the component
    of the global maximum.
    """
    n = key_flat.shape[0]
    dev = key_flat.device
    c = is_root.sum(dtype=torch.int32)
    root_key = torch.where(is_root, key_flat,
                           torch.full_like(key_flat, key_pad(key_flat.dtype)))
    order = torch.argsort(root_key, stable=True)   # non-roots first
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    slot[order] = torch.arange(n, dtype=torch.int32, device=dev)
    comp_of_root = slot - (n - c)                   # roots -> 0..C-1
    return comp_of_root[labels_flat.long()]


def candidates(key_flat: torch.Tensor, labels_flat: torch.Tensor,
               pa: PhaseA, shape: tuple[int, int], candidate_mode: str, *,
               use_pallas: bool | None = None) -> torch.Tensor:
    """Steps 3-4: the flat death-candidate mask under ``candidate_mode``."""
    h, w = shape
    if candidate_mode == "exact":
        if pa.hi_mask is not None:
            cand = exact_candidates_masked(pa.hi_mask.reshape(h, w),
                                           labels_flat.reshape(h, w))
        else:
            cand = exact_candidates(key_flat.reshape(h, w),
                                    labels_flat.reshape(h, w))
    elif candidate_mode == "paper":
        is_root = labels_flat == torch.arange(h * w, dtype=torch.int32,
                                              device=labels_flat.device)
        comp2d = reindex_components(key_flat, labels_flat,
                                    is_root).reshape(h, w)
        cand = paper_candidates(key_flat.reshape(h, w), comp2d,
                                use_pallas=use_pallas)
    else:
        raise ValueError(f"unknown candidate_mode {candidate_mode!r}")
    return cand.reshape(-1)


# ---------------------------------------------------------------------------
# Phase C: merge sweep + diagram assembly
# ---------------------------------------------------------------------------

def _as_value(truncate_value, like: torch.Tensor) -> torch.Tensor:
    """The threshold cast to ``like``'s dtype on its device (0-d)."""
    return torch.as_tensor(truncate_value, device=like.device).to(like.dtype)


def merge_components(image_flat: torch.Tensor, key_flat: torch.Tensor,
                     labels_flat: torch.Tensor, cand_flat: torch.Tensor,
                     shape: tuple[int, int], max_candidates: int,
                     truncate_value=None):
    """Process candidates in descending (value, index) order, union-find
    merge (the sequential sweep).  Returns ``(dval, dpos, overflow)``.

    The reference runs ``max_candidates`` scan steps and resolves roots by
    pointer chasing; this sweep keeps the union-find parents fully
    compressed instead (after every merge, each vertex of a merged
    component points straight at the elder root), so a root lookup is one
    gather and no step reads anything back to the host.  The roots, and
    so every death, are the same.  Steps past the last valid candidate
    change nothing in the reference and are skipped.
    """
    h, w = shape
    n = h * w
    dev = image_flat.device
    k = min(max_candidates, n)
    pad = key_pad(key_flat.dtype)

    if truncate_value is not None:
        cand_flat = cand_flat & (image_flat >= truncate_value)
    n_cand = cand_flat.sum(dtype=torch.int32)
    top_keys, top_pix = masked_top_k(key_flat, cand_flat, k)   # descending
    overflow = n_cand > k
    valid = top_keys > pad
    ok_all, basin_all = higher_neighbor_basins(
        top_pix, top_keys, key_flat, labels_flat, (h, w), valid)   # (k, 8)
    xval_all = image_flat[top_pix.long()]
    telemetry.readback()
    steps = min(int(n_cand), k)

    parent = torch.arange(n, dtype=torch.int32, device=dev)
    dval = torch.full((n + 1,), neg_inf(image_flat.dtype),
                      dtype=image_flat.dtype, device=dev)  # slot n: drop
    dpos = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    earlier = torch.ones(8, 8, dtype=torch.bool, device=dev).tril(-1)
    drop = torch.full((8,), n, dtype=torch.int64, device=dev)
    for s in range(steps):
        ok, basin, x = ok_all[s], basin_all[s], top_pix[s]
        start = torch.where(ok, basin, x)      # x is never a root: filler
        roots = parent[start.long()]
        root_key = torch.where(ok, key_flat[roots.long()], pad)
        elder = roots.gather(0, torch.argmax(root_key).view(1))
        # dup[j]: an earlier valid slot already holds root j.
        dup = ((roots[None, :] == roots[:, None]) & ok[None, :]
               & earlier).any(1)
        die = ok & ~dup & (roots != elder)
        merged = torch.where(ok, roots, -1)
        parent = torch.where((parent[:, None] == merged[None, :]).any(1),
                             elder, parent)
        tgt = torch.where(die, roots.long(), drop)
        dval.scatter_(0, tgt, xval_all[s].expand(8))
        dpos.scatter_(0, tgt, x.expand(8))
    return dval[:n], dpos[:n], overflow


def phase_c(image_flat: torch.Tensor, key_flat: torch.Tensor,
            labels_flat: torch.Tensor, cand_flat: torch.Tensor,
            shape: tuple[int, int], truncate_value=None, *,
            max_features: int, max_candidates: int,
            merge_impl: str = "scan", phase_c_impl: str = "fused",
            tournament_width: int = 2,
            use_pallas: bool | None = None) -> Diagram:
    """Stage C: elder-rule merge + essential class + diagram."""
    from repro_torch.core import parallel_merge
    from repro_torch.kernels.ph_phase_c import ops as phase_c_ops

    h, w = shape
    n = h * w
    vals = image_flat
    dev = vals.device
    is_root = labels_flat == torch.arange(n, dtype=torch.int32, device=dev)
    f = min(max_features, n)
    neg = neg_inf(vals.dtype)
    gmax = torch.argmax(key_flat).view(1)
    gmin = torch.argmin(key_flat).view(1)
    root_mask = is_root if truncate_value is None else \
        is_root & (vals >= truncate_value)
    cand_b = cand_flat if truncate_value is None else \
        cand_flat & (vals >= truncate_value)
    row_idx = torch.arange(f, device=dev)

    if merge_impl == "boruvka" and phase_c_impl == "fused":
        (_, root_pix, rvalid, dval_c, dpos_c, overflow_k,
         _rounds) = phase_c_ops.fused_merge(
            vals, key_flat, labels_flat, cand_b, root_mask, (h, w),
            max_candidates=max_candidates, max_features=max_features,
            use_pallas=use_pallas)
        if truncate_value is not None:
            undied_c = rvalid & (dpos_c < 0)
            dval_c = torch.where(undied_c, _as_value(truncate_value, dval_c),
                                 dval_c)
        # Essential class on the compact table: slot 0 is the global
        # maximum's root whenever any root exists.
        dval_c = torch.cat([torch.where(rvalid[:1], vals[gmin], dval_c[:1]),
                            dval_c[1:]])
        dpos_c = torch.cat([torch.where(rvalid[:1], gmin.to(torch.int32),
                                        dpos_c[:1]), dpos_c[1:]])
        c = root_mask.sum(dtype=torch.int32)
        row_valid = row_idx < c
        birth = torch.where(row_valid, vals[root_pix.long()], neg)
        death = torch.where(row_valid, dval_c, neg)
        p_birth = torch.where(row_valid, root_pix, -1).to(torch.int32)
        p_death = torch.where(row_valid, dpos_c, -1).to(torch.int32)
        n_unmerged = (rvalid & (dpos_c < 0)).sum(dtype=torch.int32)
        overflow = overflow_k | (c > f)
        return Diagram(birth, death, p_birth, p_death, torch.clamp(c, max=f),
                       n_unmerged, overflow)

    if merge_impl == "scan":
        dval, dpos, overflow_k = merge_components(
            vals, key_flat, labels_flat, cand_flat, (h, w), max_candidates,
            truncate_value=truncate_value)
    elif merge_impl == "boruvka":
        telemetry.readback()
        dval, dpos, overflow_k, _rounds = parallel_merge.boruvka_merge(
            vals, key_flat, labels_flat, cand_b, (h, w), max_candidates,
            n_live=int(root_mask.sum()), tournament_width=tournament_width)
    else:
        raise ValueError(f"unknown merge_impl {merge_impl!r}")

    if truncate_value is not None:
        # Sub-threshold components are background; survivors die at t.
        is_root = root_mask
        undied = is_root & (dpos < 0)
        dval = torch.where(undied, _as_value(truncate_value, dval), dval)

    # Essential class: global maximum dies at the global minimum.
    dval = dval.index_put((gmax,), vals[gmin])
    dpos = dpos.index_put((gmax,), gmin.to(torch.int32))

    _, root_pix = masked_top_k(key_flat, is_root, f, tournament_width)
    c = is_root.sum(dtype=torch.int32)
    row_valid = row_idx < c
    root_pix = root_pix.long()
    birth = torch.where(row_valid, vals[root_pix], neg)
    death = torch.where(row_valid, dval[root_pix], neg)
    p_birth = torch.where(row_valid, root_pix, -1).to(torch.int32)
    p_death = torch.where(row_valid, dpos[root_pix], -1).to(torch.int32)
    n_unmerged = (is_root & (dpos < 0)).sum(dtype=torch.int32)
    overflow = overflow_k | (c > f)
    return Diagram(birth, death, p_birth, p_death, torch.clamp(c, max=f),
                   n_unmerged, overflow)


# ---------------------------------------------------------------------------
# Full algorithm: phase_a -> phase_b -> candidates -> phase_c
# ---------------------------------------------------------------------------

def _pixhomology(image: torch.Tensor, truncate_value=None, *,
                 max_features: int = 256, max_candidates: int = 4096,
                 candidate_mode: str = "exact",
                 use_pallas: bool | None = None,
                 merge_impl: str = "scan", phase_a_impl: str = "fused",
                 strip_rows: int = 8, merge_keys: str = "rank",
                 phase_c_impl: str = "fused", tournament_width: int = 2,
                 filtration: str = "superlevel",
                 phase_a_out: PhaseA | None = None) -> Diagram:
    """Algorithm-1 core on one image with ``merge_keys`` already resolved.

    ``filtration="sublevel"`` negates the image (and threshold) on entry
    and the diagram's values on exit.  ``phase_a_out`` supplies phase A
    computed elsewhere (the batched path runs it for the whole batch at
    once).  Each stage is a :mod:`repro_torch.telemetry` span on the
    image's device.
    """
    if image.dim() != 2:
        raise ValueError(f"expected 2D image, got shape {tuple(image.shape)}")
    dev = image.device
    image = packed_keys.filtration_view(image, filtration)
    if truncate_value is not None and filtration == "sublevel":
        truncate_value = -truncate_value
    h, w = image.shape
    vals = image.reshape(-1)
    with telemetry.span("keys", dev):
        key = total_order_keys(vals, merge_keys)
    pa = phase_a_out
    if pa is None:
        with telemetry.span("phase_a", dev):
            pa = phase_a(image, phase_a_impl=phase_a_impl,
                         strip_rows=strip_rows, use_pallas=use_pallas)
    with telemetry.span("phase_b", dev):
        labels = phase_b(pa, (h, w), phase_a_impl=phase_a_impl,
                         strip_rows=strip_rows)
    with telemetry.span("candidates", dev):
        cand = candidates(key, labels, pa, (h, w), candidate_mode,
                          use_pallas=use_pallas)
    with telemetry.span("phase_c", dev):
        d = phase_c(vals, key, labels, cand, (h, w), truncate_value,
                    max_features=max_features,
                    max_candidates=max_candidates, merge_impl=merge_impl,
                    phase_c_impl=phase_c_impl,
                    tournament_width=tournament_width, use_pallas=use_pallas)
        if filtration == "sublevel":
            d = d._replace(birth=-d.birth, death=-d.death)
    return d


def pixhomology(image: torch.Tensor, truncate_value=None, *,
                merge_keys: str = "packed", **kwargs) -> Diagram:
    """0-dim PH of a 2D image tensor (Algorithm 1), superlevel by default.

    Runs on the image's device.  Returns a fixed-capacity :class:`Diagram`
    with rows sorted by descending (birth value, birth index); row 0 is the
    essential class.  ``truncate_value`` is the Variant-2 threshold
    (components born below it are dropped, merges below it skipped,
    survivors die at it).  Keyword arguments are those of the reference's
    ``pixhomology`` (``max_features``, ``max_candidates``, ``merge_impl``,
    ``phase_c_impl``, ``strip_rows``, ``filtration``, ``use_pallas``, ...).
    """
    packed_keys.check_finite(image, allow_inf=True)
    merge_keys = packed_keys.resolve_merge_keys(merge_keys, image.dtype)
    return _pixhomology(image, truncate_value, merge_keys=merge_keys,
                        **kwargs)


def stack_diagrams(diagrams) -> Diagram:
    """Stack per-image diagrams (equal capacities) along a batch axis."""
    return Diagram(*(torch.stack(list(fs)) for fs in zip(*diagrams)))


def batched_pixhomology(images: torch.Tensor, truncate_values=None, *,
                        merge_keys: str = "packed",
                        phase_a_impl: str = "fused", strip_rows: int = 8,
                        use_pallas: bool | None = None,
                        filtration: str = "superlevel",
                        **kwargs) -> Diagram:
    """PixHomology over a (B, H, W) batch: phase A runs once for the whole
    batch (one kernel launch pair), the later stages image by image, and
    the diagrams stack along a leading batch axis.

    ``truncate_values``: optional (B,) per-image Variant-2 thresholds.
    """
    if images.dim() != 3:
        raise ValueError(f"expected (B, H, W) batch, got shape "
                         f"{tuple(images.shape)}")
    packed_keys.check_finite(images, allow_inf=True)
    merge_keys = packed_keys.resolve_merge_keys(merge_keys, images.dtype)
    with telemetry.span("phase_a", images.device):
        pa = phase_a(packed_keys.filtration_view(images, filtration),
                     phase_a_impl=phase_a_impl, strip_rows=strip_rows,
                     use_pallas=use_pallas)
    diags = [_pixhomology(
        images[i], None if truncate_values is None else truncate_values[i],
        merge_keys=merge_keys, phase_a_impl=phase_a_impl,
        strip_rows=strip_rows, use_pallas=use_pallas, filtration=filtration,
        phase_a_out=PhaseA(pa.pointers[i], None if pa.hi_mask is None
                           else pa.hi_mask[i]), **kwargs)
        for i in range(images.shape[0])]
    return stack_diagrams(diags)


def num_candidates(image: torch.Tensor, candidate_mode: str = "exact",
                   truncate_value=None, *, use_pallas: bool | None = None,
                   phase_a_impl: str = "fused", strip_rows: int = 8,
                   merge_keys: str = "packed",
                   filtration: str = "superlevel") -> int:
    """Count death-point candidates (to size ``max_candidates``).  The
    total-order keys are built only on the branches that read them (the
    fused exact test needs just the phase-A bitmask)."""
    h, w = image.shape
    packed_keys.check_finite(image, allow_inf=True)
    image = packed_keys.filtration_view(image, filtration)
    if truncate_value is not None and filtration == "sublevel":
        truncate_value = -truncate_value
    merge_keys = packed_keys.resolve_merge_keys(merge_keys, image.dtype)
    pa = phase_a(image, phase_a_impl=phase_a_impl, strip_rows=strip_rows,
                 use_pallas=use_pallas)
    labels = phase_b(pa, (h, w), phase_a_impl=phase_a_impl,
                     strip_rows=strip_rows)
    key = None
    if candidate_mode != "exact" or pa.hi_mask is None:
        key = total_order_keys(image.reshape(-1), merge_keys)
    cand = candidates(key, labels, pa, (h, w), candidate_mode,
                      use_pallas=use_pallas).reshape(h, w)
    if truncate_value is not None:
        cand = cand & (image >= truncate_value)
    telemetry.readback()
    return int(cand.sum())

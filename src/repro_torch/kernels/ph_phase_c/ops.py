"""Dispatch + whole-image entry point of the fused phase-C merge.

Counterpart of ``repro.kernels.ph_phase_c.ops``:

* :func:`best_edge_reduce` — the per-round segmented reduction,
  dispatched by tensor device: a CUDA tensor runs the hand-written kernel
  unless ``use_pallas=False`` selects the plain version explicitly; a CPU
  tensor runs the plain version.  Plugged into
  :func:`repro_torch.core.parallel_merge.boruvka_forest` as ``reduce_fn``.

* :func:`fused_merge` — the whole-image fused phase C.  It compacts the
  instance first (candidates and roots gathered to capacity-sized tables
  by a cumsum scatter, only the ``max_features``-long root table sorted
  into diagram order, edge endpoints mapped to compact slots through a
  sorted lookup table) and runs the Boruvka forest on (f, E)-sized
  arrays.  Bitwise equal to the full-image Boruvka path whenever the
  roots fit ``max_features``; under root overflow both raise the same
  ``Diagram.overflow`` and the engine regrows.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import telemetry
from repro_torch.core.grid import higher_neighbor_basins
from repro_torch.core.packed_keys import key_pad
from repro_torch.core.parallel_merge import (boruvka_forest,
                                             chain_clique_edges)
from repro_torch.kernels.ph_phase_c import kernel, ref


def best_edge_reduce(key, ra, rb, nv: int, *, use_pallas: bool | None = None):
    """Per-cluster best incident edge: the CUDA kernel on CUDA tensors
    (unless ``use_pallas`` is False), the plain version otherwise."""
    if key.is_cuda and use_pallas is not False:
        return kernel.best_edge_reduce(key, ra, rb, nv)
    return ref.best_edge_reduce(key, ra, rb, nv)


def _compact_mask(key_flat, mask, k: int):
    """Gather the <= k masked lanes to a k-slot table in flat-pixel order.

    One cumsum + two scatters into a ``k + 1`` buffer whose last slot is
    the drop lane (masked lanes beyond the k-th fall there and are sliced
    off).  Returns ``(keys, pix)``: pad keys and pixel 0 on empty slots.
    """
    n = key_flat.shape[0]
    slot = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(mask & (slot < k), slot, k).long()
    keys = torch.full((k + 1,), key_pad(key_flat.dtype), dtype=key_flat.dtype,
                      device=key_flat.device)
    keys.scatter_(0, tgt, key_flat)
    pix = torch.zeros(k + 1, dtype=torch.int32, device=key_flat.device)
    pix.scatter_(0, tgt, torch.arange(n, dtype=torch.int32,
                                      device=key_flat.device))
    return keys[:k], pix[:k]


def _compact_candidate_edges(key_flat, labels_flat, cand_flat, shape,
                             max_candidates: int):
    """Chained basin edges of the compacted candidate set: flat (K*8,)
    ``(key, a, b, saddle_pixel)``, in candidate-pixel order (the merge
    forest is invariant to edge order)."""
    h, w = shape
    k = min(max_candidates, h * w)
    pad = key_pad(key_flat.dtype)
    top_keys, top_pix = _compact_mask(key_flat, cand_flat, k)
    valid = top_keys > pad
    ok, lbl = higher_neighbor_basins(top_pix, top_keys, key_flat,
                                     labels_flat, shape, valid)  # (K, 8)
    edge_ok, prev_lbl = chain_clique_edges(ok, lbl)
    keys = top_keys[:, None].expand(ok.shape)
    pixs = top_pix[:, None].expand(ok.shape)
    return (torch.where(edge_ok, keys, pad).reshape(-1),
            torch.where(edge_ok, lbl, 0).reshape(-1),
            torch.where(edge_ok, prev_lbl, 0).reshape(-1),
            pixs.reshape(-1))


def _slot_lookup(sorted_pix, order, q):
    """Binary-search ``q`` in the sorted compact-root pixel table.
    Returns ``(slot, found)``; ``slot`` is 0 where absent."""
    j = torch.searchsorted(sorted_pix, q, right=False)
    j = torch.clamp(j, 0, sorted_pix.shape[0] - 1)
    found = sorted_pix[j] == q
    return torch.where(found, order[j], 0), found


def fused_merge(image_flat, key_flat, labels_flat, cand_flat, root_mask,
                shape, *, max_candidates: int, max_features: int,
                use_pallas: bool | None = None):
    """Compact fused phase-C merge over the top-``max_features`` roots.

    ``root_mask``: (n,) bool — the diagram's root set (already filtered by
    any truncation threshold).  Returns ``(root_key, root_pix, rvalid,
    dval_c, dpos_c, overflow, rounds)``: the descending compact root
    table, per-slot death value/position, the candidate-overflow flag,
    and the Boruvka round count.
    """
    n = image_flat.shape[0]
    f = min(max_features, n)
    e_key, e_a, e_b, e_pos = _compact_candidate_edges(
        key_flat, labels_flat, cand_flat, shape, max_candidates)
    e_val = image_flat[e_pos.long()]

    # Stable ascending sort then flip reproduces argsort(...)[::-1].
    rk_c, rp_c = _compact_mask(key_flat, root_mask, f)
    order_desc = torch.argsort(rk_c, stable=True).flip(0)
    root_key = rk_c[order_desc]
    root_pix = rp_c[order_desc]
    rvalid = root_key > key_pad(root_key.dtype)

    imax = torch.iinfo(torch.int32).max
    pix_or_max = torch.where(rvalid, root_pix, imax)
    order = torch.argsort(pix_or_max, stable=True).to(torch.int32)
    sorted_pix = pix_or_max[order.long()].contiguous()
    sa, fa = _slot_lookup(sorted_pix, order, e_a)
    sb, fb = _slot_lookup(sorted_pix, order, e_b)
    e_key_c = torch.where(fa & fb, e_key, key_pad(e_key.dtype))

    telemetry.readback()
    c = int(root_mask.sum())
    reduce_fn = functools.partial(best_edge_reduce, use_pallas=use_pallas)
    dval_c, dpos_c, rounds = boruvka_forest(
        root_key, e_key_c, e_val, e_pos, sa, sb,
        n_live=min(c, f), reduce_fn=reduce_fn)

    n_cand = cand_flat.sum(dtype=torch.int32)
    overflow = n_cand > min(max_candidates, n)
    return root_key, root_pix, rvalid, dval_c, dpos_c, overflow, rounds

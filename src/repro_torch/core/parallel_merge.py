"""Parallel merge phase: Boruvka rounds instead of the sequential sweep.

Counterpart of ``repro.core.parallel_merge``.  0-dim superlevel
persistence is elder-rule pairing on the maximum spanning forest of the
saddle graph, which Boruvka builds in O(log C) parallel rounds: every
cluster finds its highest incident saddle edge (:func:`best_edge_reduce`,
the per-round reduction the phase-C CUDA kernel replaces), every cluster
whose best edge leads to an older cluster dies there, and union pointers
are resolved by pointer doubling.  The output is bitwise equal to the
sequential sweep and to the union-find oracle.

Each round reads two values back to the host (the loop condition), and
each pointer-doubling resolve one per iteration; the round count is
returned so callers can report it.
"""
from __future__ import annotations

import torch

from repro_torch import telemetry
from repro_torch.core.grid import (fixed_point_iterate, gather_flat,
                                   higher_neighbor_basins, neg_inf)
from repro_torch.core.packed_keys import key_pad, masked_top_k, packed_index


def candidate_edges(key_flat, labels_flat, cand_flat, shape,
                    max_candidates: int, tournament_width: int = 2):
    """Top-K candidates -> chained basin edges (K*8,) flat: (key, a, b)."""
    h, w = shape
    k = min(max_candidates, h * w)
    pad = key_pad(key_flat.dtype)
    top_keys, top_pix = masked_top_k(key_flat, cand_flat, k,
                                     tournament_width)
    valid = top_keys > pad
    ok, lbl = higher_neighbor_basins(top_pix, top_keys, key_flat,
                                     labels_flat, shape, valid)  # (K, 8)
    edge_ok, prev_lbl = chain_clique_edges(ok, lbl)
    keys = top_keys[:, None].expand(ok.shape)
    return (torch.where(edge_ok, keys, pad).reshape(-1),
            torch.where(edge_ok, lbl, 0).reshape(-1),
            torch.where(edge_ok, prev_lbl, 0).reshape(-1))


def chain_clique_edges(ok: torch.Tensor, lbl: torch.Tensor):
    """Chain consecutive valid neighbor slots into clique-spanning edges.

    ``ok``/``lbl``: (K, 8).  Edge j connects slot j's basin to the previous
    valid slot's basin (the reference's 8-step scan, written as a loop over
    slots).  Returns ``(edge_ok, prev_lbl)``.
    """
    prev = torch.full(ok.shape[:-1], -1, dtype=lbl.dtype, device=lbl.device)
    prevs = []
    for j in range(ok.shape[-1]):
        o, l = ok[..., j], lbl[..., j]
        prevs.append(torch.where(o, prev, -1))
        prev = torch.where(o, l, prev)
    prev_lbl = torch.stack(prevs, dim=-1)
    edge_ok = ok & (prev_lbl >= 0) & (prev_lbl != lbl)
    return edge_ok, prev_lbl


def best_edge_reduce(key, ra, rb, nv: int):
    """Per-cluster best incident edge: ``(best key, winning edge index)``.

    Plain version of the phase-C kernel.  ``key``: (E,) saddle keys with the
    dtype-min pad on dead lanes; ``ra``/``rb``: (E,) int32 endpoints in
    ``[0, nv)`` on every lane.  ``best[v]`` is the largest live key
    touching v (pad where none); ``win[v]`` the largest edge index among
    live edges touching v with ``key == best[v]`` (-1 where none).  Both
    passes are integer max reductions, so any order gives the same bits.
    """
    e_pad = key_pad(key.dtype)
    alive = key > e_pad
    drop = torch.full_like(ra, nv)
    best = torch.full((nv + 1,), e_pad, dtype=key.dtype, device=key.device)
    best.scatter_reduce_(0, torch.where(alive, ra, drop).long(), key, "amax")
    best.scatter_reduce_(0, torch.where(alive, rb, drop).long(), key, "amax")
    best = best[:nv]
    eidx = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    hit_a = alive & (key == best[ra.long()])
    hit_b = alive & (key == best[rb.long()])
    win = torch.full((nv + 1,), -1, dtype=torch.int32, device=key.device)
    win.scatter_reduce_(0, torch.where(hit_a, ra, drop).long(),
                        torch.where(hit_a, eidx, -1), "amax")
    win.scatter_reduce_(0, torch.where(hit_b, rb, drop).long(),
                        torch.where(hit_b, eidx, -1), "amax")
    return best, win[:nv]


def boruvka_forest(v_rank, e_rank, e_val, e_pos, e_a, e_b, *,
                   n_live: int | None = None, reduce_fn=None):
    """Elder-rule Boruvka forest over an abstract vertex/edge instance.

    ``v_rank``: (V,) birth key per vertex; ``e_rank``: (E,) saddle key per
    edge (dtype-min = padding); ``e_val``/``e_pos``: (E,) death value and
    position recorded when an edge kills a vertex; ``e_a``/``e_b``: (E,)
    endpoint vertex ids.  ``n_live`` bounds the clusters that can merge: a
    spanning forest does at most ``n_live - 1`` merges, so the loop stops
    once that many have died.  ``reduce_fn`` replaces
    :func:`best_edge_reduce` (the phase-C kernel's hook).

    Returns ``(dval, dpos, rounds)``.
    """
    nv = v_rank.shape[0]
    dev = v_rank.device
    e_pad = key_pad(e_rank.dtype)
    reduce_ = best_edge_reduce if reduce_fn is None else reduce_fn

    parent = torch.arange(nv, dtype=torch.int32, device=dev)
    dval = torch.full((nv,), neg_inf(e_val.dtype), dtype=e_val.dtype,
                      device=dev)
    dpos = torch.full((nv,), -1, dtype=torch.int32, device=dev)
    merge_cap = (torch.iinfo(torch.int32).max if n_live is None
                 else int(n_live) - 1)
    me = torch.arange(nv, dtype=torch.int32, device=dev)
    e_a_l, e_b_l = e_a.long(), e_b.long()

    any_alive, merges, rounds = True, 0, 0
    while any_alive and merges < merge_cap:
        roots, _ = fixed_point_iterate(lambda r: gather_flat(r, r), parent)
        ra = roots[e_a_l]
        rb = roots[e_b_l]
        alive = (e_rank > e_pad) & (ra != rb)
        key = torch.where(alive, e_rank, e_pad)

        best, win = reduce_(key, ra, rb, nv)

        has = win >= 0
        wi = torch.clamp(win, min=0).long()
        wa = roots[e_a_l[wi]]
        wb = roots[e_b_l[wi]]
        other = torch.where(wa == me, wb, wa)
        die = has & (v_rank[other.long()] > v_rank) & (roots == me)

        parent = torch.where(die, other, parent)
        dval = torch.where(die, e_val[wi], dval)
        dpos = torch.where(die, e_pos[wi], dpos)
        telemetry.readback()
        n_die, alive_any = torch.stack(
            [die.sum(), alive.any().long()]).tolist()   # one readback
        merges += n_die
        any_alive = bool(alive_any)
        rounds += 1
    return dval, dpos, rounds


def boruvka_merge(image_flat, key_flat, labels_flat, cand_flat, shape,
                  max_candidates: int, *, n_live: int | None = None,
                  tournament_width: int = 2, reduce_fn=None):
    """Whole-image Boruvka merge over all n pixel-vertices (the
    ``phase_c_impl="xla"`` path).  Returns ``(dval, dpos, overflow,
    rounds)``."""
    n = image_flat.shape[0]
    e_key, e_a, e_b = candidate_edges(key_flat, labels_flat, cand_flat,
                                      shape, max_candidates,
                                      tournament_width)
    if key_flat.dtype == torch.int64:
        e_pos = torch.clamp(packed_index(e_key), min=0)   # pad -> pixel 0
    else:
        perm = torch.argsort(key_flat, stable=True).to(torch.int32)
        e_pos = perm[torch.clamp(e_key, min=0).long()]
    e_val = image_flat[e_pos.long()]

    dval, dpos, rounds = boruvka_forest(key_flat, e_key, e_val, e_pos,
                                        e_a, e_b, n_live=n_live,
                                        reduce_fn=reduce_fn)
    n_cand = cand_flat.sum(dtype=torch.int32)
    overflow = n_cand > min(max_candidates, n)
    return dval, dpos, overflow, rounds

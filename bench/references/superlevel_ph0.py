"""Plain reference: 0-dimensional superlevel persistence of a 2-D frame.

Written in plain PyTorch for this benchmark alone; it imports nothing of
the program under test.  The diagram it returns is the one the
union-find sweep defines (pixels in descending (value, flat index) order,
8-connectivity, the younger component dies where two meet), restricted to
pixels at or above an optional threshold ``t``: a component born below
``t`` is dropped, merges below ``t`` are skipped, and a component still
alive at ``t`` dies there (death ``t``, death pixel -1).  The component
of the global maximum dies at the global minimum of the whole frame.
Rows are sorted by descending (birth value, birth pixel).

The sweep is sequential; this restates it so that it runs in bulk on the
device:

1. every pixel points at its highest 8-neighbour (itself if none is
   higher); doubling the pointers gives each pixel its basin, named by
   the basin's maximum, which is a local maximum;
2. two basins meet at level ``v`` through any adjacent pixel pair whose
   lower pixel has key ``v``, so each pair of touching basins keeps only
   its highest such pass (the graph of basins and passes has the same
   components at every level as the superlevel sets);
3. the elder rule on that graph by contraction: in each round every
   component takes its highest remaining pass; where the component on
   the other side has an older maximum, this component dies at that pass
   and is folded into it.  A pass is highest among the remaining ones at
   its component, so the component's members above it are exactly those
   folded in already, and a folded member lies above every pass still
   left at it; the round therefore decides what the sweep decides.

The module is also the cell's check (``expected``, ``compare`` and
``LIMITS``): every field of every returned frame's diagram against the
reference's, exactly.  The numbers compared, each with the limit 0:

* ``count_diff``: the summed gap between the program's and the
  reference's feature counts (a frame with no returned diagram counts
  its whole reference count);
* ``rows_diff``: rows below both counts whose birth, death, birth pixel
  or death pixel differ, plus padding rows past the count that are not
  (-inf, -inf, -1, -1);
* ``unmerged_diff``: the summed gap in roots that never died;
* ``overflow``: diagrams returned with the overflow flag set.
"""
from __future__ import annotations

import numpy as np
import torch

# 8-neighbourhood, and the four offsets that visit each adjacent pair once.
_NEIGHBOURS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
               (1, 1))
_PAIRS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _ranks(values: torch.Tensor) -> torch.Tensor:
    """Position of each pixel in ascending (value, flat index) order."""
    order = torch.sort(values, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=values.device)
    return rank


def _shifted(grid: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """``out[r, c] = grid[r + dr, c + dc]``, ``fill`` outside the frame."""
    h, w = grid.shape
    out = torch.full_like(grid, fill)
    out[max(0, -dr):h - max(0, dr), max(0, -dc):w - max(0, dc)] = \
        grid[max(0, dr):h - max(0, -dr), max(0, dc):w - max(0, -dc)]
    return out


def _basins(rank2d: torch.Tensor) -> torch.Tensor:
    """Flat index of the local maximum each pixel's steepest ascent ends at."""
    h, w = rank2d.shape
    idx = torch.arange(h * w, device=rank2d.device).reshape(h, w)
    best_rank, best_idx = rank2d, idx
    for dr, dc in _NEIGHBOURS:
        r = _shifted(rank2d, dr, dc, -1)
        higher = r > best_rank
        best_rank = torch.where(higher, r, best_rank)
        best_idx = torch.where(higher, _shifted(idx, dr, dc, -1), best_idx)
    ptr = best_idx.reshape(-1)
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            return ptr
        ptr = nxt


def _passes(rank2d, basin2d, keep2d):
    """Highest pass between every two touching basins: ``(a, b, pass)``
    with ``a < b`` basin maxima and ``pass`` the flat index of the lower
    pixel of the highest adjacent pair joining them (kept pixels only)."""
    h, w = rank2d.shape
    idx = torch.arange(h * w, device=rank2d.device).reshape(h, w)
    ea, eb, ep = [], [], []
    for dr, dc in _PAIRS:
        r0, r1 = 0, h - dr
        c0, c1 = max(0, -dc), w - max(0, dc)
        sl0 = (slice(r0, r1), slice(c0, c1))
        sl1 = (slice(r0 + dr, r1 + dr), slice(c0 + dc, c1 + dc))
        la, lb = basin2d[sl0].reshape(-1), basin2d[sl1].reshape(-1)
        ok = (la != lb) & keep2d[sl0].reshape(-1) & keep2d[sl1].reshape(-1)
        ra, rb = rank2d[sl0].reshape(-1)[ok], rank2d[sl1].reshape(-1)[ok]
        ia, ib = idx[sl0].reshape(-1)[ok], idx[sl1].reshape(-1)[ok]
        la, lb = la[ok], lb[ok]
        ea.append(torch.minimum(la, lb))
        eb.append(torch.maximum(la, lb))
        ep.append(torch.where(ra < rb, ia, ib))
    a, b, p = torch.cat(ea), torch.cat(eb), torch.cat(ep)
    if a.numel() == 0:
        return a, b, p
    n = h * w
    # Highest pass first, then group by basin pair (stable): the first of
    # each group is its highest pass.
    rank_flat = rank2d.reshape(-1)
    order = torch.argsort(rank_flat[p], descending=True, stable=True)
    a, b, p = a[order], b[order], p[order]
    order = torch.argsort(a * n + b, stable=True)
    a, b, p = a[order], b[order], p[order]
    pair = a * n + b
    first = torch.ones_like(pair, dtype=torch.bool)
    first[1:] = pair[1:] != pair[:-1]
    return a[first], b[first], p[first]


def _elder_contraction(node_rank, ea, eb, pass_rank):
    """Death pass of every node (index into the edge list, -1 if none)
    under the elder rule; ``ea``/``eb`` are node ids, ``pass_rank`` the
    edges' heights (distinct up to edges sharing a pass pixel)."""
    dev = node_rank.device
    m = node_rank.numel()
    n_e = ea.numel()
    rep = torch.arange(m, device=dev)
    died_at = torch.full((m,), -1, dtype=torch.long, device=dev)
    eid = torch.arange(n_e, device=dev)
    # Edge order: height first, then edge id; unique, so every component
    # takes exactly one edge a round.
    order_key = pass_rank * (n_e + 1) + eid
    a, b, alive = ea.clone(), eb.clone(), torch.ones(n_e, dtype=torch.bool,
                                                     device=dev)
    while bool(alive.any()):
        live = alive.nonzero().squeeze(1)
        k, la, lb = order_key[live], a[live], b[live]
        best = torch.full((m,), -1, dtype=torch.long, device=dev)
        best.scatter_reduce_(0, la, k, "amax")
        best.scatter_reduce_(0, lb, k, "amax")
        comps = (best >= 0).nonzero().squeeze(1)
        e = best[comps] % (n_e + 1)
        other = torch.where(a[e] == comps, b[e], a[e])
        dies = node_rank[other] > node_rank[comps]
        if not bool(dies.any()):
            raise RuntimeError("elder contraction made no progress")
        dead, into = comps[dies], other[dies]
        died_at[dead] = e[dies]
        rep[dead] = into
        while True:
            nxt = rep[rep]
            if torch.equal(nxt, rep):
                break
            rep = nxt
        a[live], b[live] = rep[la], rep[lb]
        alive[live] = a[live] != b[live]
    return died_at


def persistence_diagram(frame: torch.Tensor, t: float | None = None) -> dict:
    """The diagram of a 2-D float32 frame (on any device) as host numpy
    arrays: ``birth``, ``death`` (float32), ``p_birth``, ``p_death``
    (int64, -1 where none), and ``count`` and ``n_unmerged`` (ints).
    ``t`` is the threshold as a float32 value, or None."""
    if frame.dim() != 2:
        raise ValueError(f"expected a 2-D frame, got {tuple(frame.shape)}")
    h, w = frame.shape
    vals = frame.reshape(-1)
    rank = _ranks(vals)
    rank2d = rank.reshape(h, w)
    basin = _basins(rank2d)
    keep = torch.ones_like(vals, dtype=torch.bool) if t is None else \
        vals >= torch.tensor(t, dtype=vals.dtype, device=vals.device)
    roots = (basin == torch.arange(h * w, device=vals.device)) & keep
    node_pix = roots.nonzero().squeeze(1)
    # Nodes in descending birth order: that is also the diagram's order.
    node_pix = node_pix[torch.argsort(rank[node_pix], descending=True)]
    a, b, p = _passes(rank2d, basin.reshape(h, w), keep.reshape(h, w))
    slot = torch.full((h * w,), -1, dtype=torch.long, device=vals.device)
    slot[node_pix] = torch.arange(node_pix.numel(), device=vals.device)
    died_at = _elder_contraction(rank[node_pix], slot[a], slot[b], rank[p])
    dead = died_at >= 0
    p_death = torch.where(dead, p[died_at.clamp(min=0)], -1) \
        if p.numel() else torch.full_like(died_at, -1)
    death = torch.where(dead, vals[p_death.clamp(min=0)],
                        torch.tensor(float("nan") if t is None else t,
                                     dtype=vals.dtype, device=vals.device))
    survivors = int((~dead).sum())
    if node_pix.numel():
        gmin = int(torch.argmin(rank))
        death[0] = vals[gmin]
        p_death[0] = gmin
    return {"birth": vals[node_pix].cpu().numpy(),
            "death": death.cpu().numpy(),
            "p_birth": node_pix.cpu().numpy(),
            "p_death": p_death.cpu().numpy(),
            "count": int(node_pix.numel()),
            "n_unmerged": max(0, survivors - 1)}


# -- the check ---------------------------------------------------------------

LIMITS = {"count_diff": 0, "rows_diff": 0, "unmerged_diff": 0,
          "overflow": 0}


def expected(inputs, device) -> list[dict]:
    """The reference's diagram of every frame of one call's inputs:
    ``(frames, thresholds)``, a (B, H, W) host array and B float32
    thresholds or None."""
    frames, thresholds = inputs
    out = []
    for i in range(frames.shape[0]):
        frame = torch.from_numpy(np.ascontiguousarray(frames[i])).to(device)
        out.append(persistence_diagram(
            frame, None if thresholds is None else thresholds[i]))
        del frame
    return out


def _as_np(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _compare_frame(fields: tuple, ref: dict) -> dict:
    birth, death, pb, pd = (_as_np(f).reshape(-1) for f in fields[:4])
    count = int(fields[4])
    c_ref = int(ref["count"])
    k = min(count, c_ref, birth.shape[0])
    differ = ((birth[:k].astype(np.float64) != ref["birth"][:k])
              | (death[:k].astype(np.float64) != ref["death"][:k])
              | (pb[:k].astype(np.int64) != ref["p_birth"][:k])
              | (pd[:k].astype(np.int64) != ref["p_death"][:k]))
    pad = slice(min(count, birth.shape[0]), None)
    bad_pad = ((birth[pad] != -np.inf) | (death[pad] != -np.inf)
               | (pb[pad] != -1) | (pd[pad] != -1))
    return {"count_diff": abs(count - c_ref),
            "rows_diff": int(differ.sum()) + int(bad_pad.sum()),
            "unmerged_diff": abs(int(fields[5]) - int(ref["n_unmerged"])),
            "overflow": int(bool(fields[6]))}


def compare(refs: list[dict], output: tuple) -> dict:
    """The numbers of ``LIMITS`` for one call: ``output`` is its diagram
    in host memory, fields in the ``Diagram`` order (birth, death,
    p_birth, p_death, count, n_unmerged, overflow), one frame's or with a
    leading batch axis."""
    if output[0].dim() == 1:
        rows = [output]
    else:
        rows = [tuple(f[i] for f in output)
                for i in range(output[0].shape[0])]
    total = dict.fromkeys(LIMITS, 0)
    for fields, ref in zip(rows, refs):
        for k, v in _compare_frame(fields, ref).items():
            total[k] += v
    total["count_diff"] += sum(int(r["count"]) for r in refs[len(rows):])
    total["count_diff"] += sum(int(f[4]) for f in rows[len(refs):])
    return total

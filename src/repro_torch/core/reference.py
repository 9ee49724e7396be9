"""Classical union-find oracle for 0-dim superlevel persistent homology.

The port's own numpy copy of ``repro.core.reference``: pixels are
processed in descending (value, flat_index) order, an edge to each
already-processed 8-neighbor is union'd, and when two components merge the
younger (smaller birth key) dies at the current pixel (elder rule).  The
essential class (global maximum) dies at the global minimum.  PixHomology
must match it exactly, birth/death pixel positions included.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.grid import NEIGHBOR_OFFSETS


def persistence_oracle(image: np.ndarray) -> np.ndarray:
    """Full diagram as a (C, 4) float64 array of rows
    [birth, death, p_birth, p_death], sorted by descending
    (birth value, birth index); p_* are flat pixel indices."""
    img = np.asarray(image)
    h, w = img.shape
    n = h * w
    vals = img.reshape(-1)

    order_asc = np.argsort(vals, kind="stable")
    order = order_asc[::-1]
    rank = np.empty(n, np.int64)
    rank[order_asc] = np.arange(n)

    parent = np.full(n, -1, np.int64)   # -1 = not yet born
    comp_max = np.empty(n, np.int64)    # root -> pixel index of its maximum

    def find(p: int) -> int:
        root = p
        while parent[root] != root:
            root = parent[root]
        while parent[p] != root:        # path compression
            parent[p], p = root, parent[p]
        return root

    records = []
    for p in order:
        r, c = divmod(int(p), w)
        roots = []
        for dr, dc in NEIGHBOR_OFFSETS:
            rr, cc = r + dr, c + dc
            if not (0 <= rr < h and 0 <= cc < w):
                continue
            q = rr * w + cc
            if parent[q] < 0:
                continue
            root = find(q)
            if root not in roots:
                roots.append(root)
        if not roots:
            parent[p] = p               # local maximum: a component is born
            comp_max[p] = p
            continue
        elder = max(roots, key=lambda rt: rank[comp_max[rt]])
        parent[p] = elder
        for rt in roots:
            if rt == elder:
                continue
            records.append((vals[comp_max[rt]], vals[p],
                            int(comp_max[rt]), int(p)))
            parent[rt] = elder

    gmax = int(order[0])
    gmin = int(order[-1])
    records.append((vals[gmax], vals[gmin], gmax, gmin))

    rec = np.array(records, dtype=np.float64).reshape(-1, 4)
    key = np.lexsort((rec[:, 2], rec[:, 0]))[::-1]
    return rec[key]


def diagram_to_array(diag) -> np.ndarray:
    """Convert a (non-batched) Diagram — tensors on any device, or numpy
    fields — to the oracle's (C, 4) layout."""
    from repro_torch.core.pixhomology import diagram_to_numpy
    d = diagram_to_numpy(diag)
    count = int(d.count)
    return np.stack([
        np.asarray(d.birth[:count], np.float64),
        np.asarray(d.death[:count], np.float64),
        np.asarray(d.p_birth[:count], np.float64),
        np.asarray(d.p_death[:count], np.float64),
    ], axis=1)

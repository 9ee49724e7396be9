"""The yardstick for kernel rooflines: NVIDIA H100 SXM data-sheet rates
and each hand-written kernel's least traffic, from its launch arguments.

Frozen copies: the rate is ``roofline/analysis.py``'s ``HBM_BW``, the byte
counts are the bounds of PERF.md's kernel table.  The program may change;
this does not move with it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3, data sheet, at the 700 W limit


def phase_a_bytes(n_pixels: int, itemsize: int) -> int:
    """Fused phase A: the image read once, pointer and mask (int32) each
    written once."""
    return n_pixels * (itemsize + 8)


def best_edge_bytes(n_edges: int, key_bytes: int, n_live: int,
                    n_vertices: int) -> int:
    """One best-edge launch: every key read, both int32 endpoints of each
    live edge read, the (key, int32 winner) table of ``n_vertices``
    written (``8·E + 8·live + 12·nv`` with int64 keys)."""
    return n_edges * key_bytes + 8 * n_live + (key_bytes + 4) * n_vertices


def bound_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S

"""A source-injection stream over one star field, drawn on the device from
the run's seed: one survey field processed again and again, each time
with a few synthetic sources added (a completeness run, as in DES's
Balrog, Suchyta et al. 2016), as the program's README streams it with
``FrameSequence(grid=(10, 10), dirty_frac=0.05)``.

Frame 0 is the base field: ``star_field``'s frame of the configuration's
recipe (a pool of one frame, so its star count is the nominal one).
Frame ``i`` > 0 is a realisation: the base plus ``sources_per_tile``
Gaussian sources in each of ``max(1, ceil(dirty_frac * tiles))`` tiles of
the ``inject.grid``, the tiles drawn from the seed without repeats.  A
source has amplitude ``amp * U(amp_factor_min, amp_factor_max)``, PSF
sigma ``U(sigma_min, sigma_max)`` and a ``stamp``-wide square centred on
a pixel at least ``stamp // 2 + 2`` pixels inside its tile, so no other
tile's halo-padded window changes.  Sources are added one after another
in a fixed order, so one seed gives the same frames to the bit.  This is
the benchmark's own recipe in torch; the program's ``FrameSequence`` is
not used, so the inputs do not move with the program.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import harness.spec as spec

BENCH_DIR = Path(__file__).resolve().parents[1]


def n_dirty(inject: dict, n_tiles: int) -> int:
    """Tiles a realisation changes: ``ceil(dirty_frac * n_tiles)``, at
    least one and at most every tile."""
    k = int(np.ceil(float(inject["dirty_frac"]) * n_tiles))
    return min(n_tiles, max(1, k))


def injections(inject: dict, size: int, grid, n: int, seed: int) -> list:
    """For each realisation ``1..n``: ``(dirty, sources)``, its sorted
    dirty tiles and its sources ``(row, col, amplitude, sigma)`` in the
    order they are added."""
    gr, gc = int(grid[0]), int(grid[1])
    if size % gr or size % gc:
        raise ValueError(f"grid {tuple(grid)} does not divide {size}")
    tr, tc = size // gr, size // gc
    margin = int(inject["stamp"]) // 2 + 2
    if tr <= 2 * margin or tc <= 2 * margin:
        raise ValueError(f"tiles {tr}x{tc} are too small for the stamp")
    k = n_dirty(inject, gr * gc)
    a_lo, a_hi = float(inject["amp_factor_min"]), float(
        inject["amp_factor_max"])
    s_lo, s_hi = float(inject["sigma_min"]), float(inject["sigma_max"])
    out = []
    for i in range(1, n + 1):
        rng = np.random.default_rng(np.random.SeedSequence(
            [abs(int(seed)), int(seed < 0), 31, i]))
        dirty = np.sort(rng.choice(gr * gc, size=k, replace=False))
        sources = []
        for t in dirty:
            r0, c0 = (int(t) // gc) * tr, (int(t) % gc) * tc
            for _ in range(int(inject["sources_per_tile"])):
                sources.append((r0 + int(rng.integers(margin, tr - margin)),
                                c0 + int(rng.integers(margin, tc - margin)),
                                float(inject["amp"]) * rng.uniform(a_lo,
                                                                   a_hi),
                                rng.uniform(s_lo, s_hi)))
        out.append((dirty, sources))
    return out


def draw(frame: dict, n: int, seed: int, device, grid=None
         ) -> tuple[torch.Tensor, list]:
    """``(frames, dirty)``: the base and ``n`` realisations as one
    (n + 1, size, size) float32 tensor on ``device``, and each
    realisation's sorted dirty tiles.  ``grid`` overrides
    ``frame["inject"]["grid"]``."""
    size = int(frame["size"])
    inject = frame["inject"]
    plan = injections(inject, size,
                      inject["grid"] if grid is None else grid, n, seed)
    star_field = spec.load_module("recipes", "star_field", BENCH_DIR)
    frames = torch.empty((n + 1, size, size), dtype=torch.float32,
                         device=device)
    frames[0] = star_field.draw(frame, 1, seed, device)[0]
    half = int(inject["stamp"]) // 2
    off = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    r2 = off.view(-1, 1) ** 2 + off.view(1, -1) ** 2
    for i, (_, sources) in enumerate(plan, 1):
        frames[i] = frames[0]
        for row, col, amp, sigma in sources:
            g = amp * torch.exp(-r2 / (2.0 * sigma * sigma))
            frames[i, row - half:row + half + 1,
                   col - half:col + half + 1] += g
    return frames, [dirty for dirty, _ in plan]

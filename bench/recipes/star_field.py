"""The synthetic star field of PixHomology (arXiv:2404.08245, Sec. 6.2),
drawn on the device from the run's seed.

    frame = sky + N(0, read_noise) + sum_i A_i * exp(-r_i^2 / (2 sigma_i^2))

over a ``stamp``-wide square around each star, with power-law amplitudes
in [amp_min, amp_max] (faint objects dominate), PSF sigmas uniform in
[sigma_min, sigma_max] and uniform positions, ``density`` stars per pixel
(about 340k on 10240²).  This is the benchmark's own copy of the recipe
in torch, so the inputs do not move with the program.

The recipe varies each frame's star count by up to ``count_spread``
either way.  Here the pool's factors are a fixed stratified set that the
seed only shuffles, so every seed gives the pool the same amount of work
in another order; positions, amplitudes, sigmas and noise are the seed's.
Overlapping stars are added in a fixed order, so one seed gives one frame
to the bit.
"""
from __future__ import annotations

import numpy as np
import torch


def frame_seed(seed: int, i: int) -> int:
    """A 63-bit generator seed for frame ``i`` (``-1``: the pool's order)
    of the run seeded ``seed`` (any whole number)."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), 27,
                                    i + 1])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def count_factors(n: int, spread: float, seed: int) -> list[float]:
    """``n`` star-count factors evenly over [1 - spread, 1 + spread], in
    an order drawn from ``seed``."""
    base = [1.0 - spread + 2.0 * spread * (i + 0.5) / n for i in range(n)]
    order = np.random.default_rng(frame_seed(seed, -1)).permutation(n)
    return [base[j] for j in order]


def draw(spec: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` frames of ``spec`` as one (n, size, size) float32 tensor on
    ``device``."""
    size = int(spec["size"])
    out = torch.empty((n, size, size), dtype=torch.float32, device=device)
    factors = count_factors(n, float(spec["count_spread"]), seed)
    for i in range(n):
        out[i] = _frame(spec, size, factors[i], frame_seed(seed, i), device)
    return out


def _add_in_order(flat: torch.Tensor, idx: torch.Tensor,
                  val: torch.Tensor) -> None:
    """``flat[idx] += val`` with repeated indices summed one after another
    in their order in ``idx``, so the float sums repeat to the bit: the
    k-th contribution of every pixel is added in pass k."""
    order = torch.argsort(idx, stable=True)
    idx, val = idx[order], val[order]
    start = torch.ones_like(idx, dtype=torch.bool)
    start[1:] = idx[1:] != idx[:-1]
    first = start.nonzero().squeeze(1)
    rank = torch.arange(idx.numel(), device=idx.device) \
        - first[torch.cumsum(start, 0) - 1]
    for k in range(int(rank.max()) + 1 if idx.numel() else 0):
        sel = rank == k
        at = idx[sel]
        flat[at] = flat[at] + val[sel]


def _frame(spec, size, factor, gseed, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(gseed)
    f32 = dict(dtype=torch.float32, device=device)
    img = torch.randn((size, size), generator=gen, **f32)
    img.mul_(float(spec["read_noise"])).add_(float(spec["sky"]))

    n_stars = max(1, int(max(1, int(spec["density_per_px"] * size * size))
                         * factor))
    u = torch.rand(n_stars, generator=gen, dtype=torch.float64,
                   device=device)
    lo, hi = float(spec["amp_min"]), float(spec["amp_max"])
    amp = (lo * (1 - u * (1 - (hi / lo) ** -0.8)) ** (-1 / 0.8)).float()
    yx = torch.rand((n_stars, 2), generator=gen, **f32) * size
    s_lo, s_hi = float(spec["sigma_min"]), float(spec["sigma_max"])
    sig = s_lo + (s_hi - s_lo) * torch.rand(n_stars, generator=gen, **f32)

    half = int(spec["stamp"]) // 2
    off = torch.arange(-half, half + 1, device=device)
    iy, ix = yx[:, 0].floor(), yx[:, 1].floor()
    dy, dx = yx[:, 0] - iy, yx[:, 1] - ix
    flat = img.view(-1)
    # Stars in chunks keep the stamp temporaries near 1 GB at 10240².
    chunk = 1 << 20
    for s in range(0, n_stars, chunk):
        e = min(n_stars, s + chunk)
        oy = off.view(1, -1, 1).float() - dy[s:e].view(-1, 1, 1)
        ox = off.view(1, 1, -1).float() - dx[s:e].view(-1, 1, 1)
        g = amp[s:e].view(-1, 1, 1) * torch.exp(
            -(oy * oy + ox * ox) / (2 * sig[s:e].view(-1, 1, 1) ** 2))
        rows = iy[s:e].long().view(-1, 1, 1) + off.view(1, -1, 1)
        cols = ix[s:e].long().view(-1, 1, 1) + off.view(1, 1, -1)
        inside = (rows >= 0) & (rows < size) & (cols >= 0) & (cols < size)
        _add_in_order(flat, (rows * size + cols).expand_as(g)[inside],
                      g[inside])
    return img

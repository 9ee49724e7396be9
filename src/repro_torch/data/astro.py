"""Synthetic astronomical images (paper §6.2) and their thresholds.

The port's own copy of the frame recipe in ``repro.data.astro``:

  image = sky + N(0, read_noise) + sum_i A_i * G(sigma_i, x_i, y_i)

with power-law star amplitudes and PSF sigmas ~ U(1, 2.5) px, about 3.4
objects per kilopixel².  The read noise is seeded per row, so
:func:`generate_window` renders any window bit-identically to the same
slice of :func:`generate_image`.  Frames are bit-identical to the
reference package's for the same ``image_id`` and ``size`` (the tests hold
them equal), and :func:`filter_threshold` gives the Variant-2 threshold
of a filter level.  :class:`AstroImage` is the tile provider the tiled
path stages one halo tile at a time, and :class:`FrameSequence` the
survey stream (one base field plus transients) delta-PH exists for.
"""
from __future__ import annotations

import numpy as np
import torch

DENSITY_PER_KPX2 = 3.4 / 1000.0    # paper: ~340k objects on 10k x 10k


def star_params(image_id: int, size: int,
                *, density: float = DENSITY_PER_KPX2,
                amp_min: float = 10.0, amp_max: float = 5000.0):
    """Star draws for an image id (separate stream from the noise so the
    Variant-3 cost model can evaluate them without rendering the frame).

    The per-image star count is itself random (Poisson-like via a +-40%
    uniform factor) — this is what makes the workload skewed and the
    paper's straggler discussion meaningful."""
    rng = np.random.default_rng(np.random.SeedSequence([77, image_id, 1]))
    base = max(1, int(density * size * size))
    n_stars = max(1, int(base * rng.uniform(0.6, 1.4)))
    u = rng.random(n_stars)
    # Power-law amplitudes (faint objects dominate, like real number counts).
    a = amp_min * (1 - u * (1 - (amp_max / amp_min) ** -0.8)) ** (-1 / 0.8)
    xy = rng.random((n_stars, 2)) * size
    sig = rng.uniform(1.0, 2.5, n_stars)
    return a, xy, sig


def generate_window(image_id: int, row0: int, col0: int, h: int, w: int,
                    *, size: int = 1024,
                    density: float = DENSITY_PER_KPX2,
                    sky: float = 100.0, read_noise: float = 5.0,
                    amp_min: float = 10.0, amp_max: float = 5000.0,
                    stamp: int = 15) -> np.ndarray:
    """The ``[row0:row0+h, col0:col0+w]`` window of image ``image_id``,
    bit-identical to the same slice of :func:`generate_image` while only
    ever materializing the window itself (noise is drawn row by row from a
    per-row stream; only stars whose stamp intersects the window are
    rendered, and skipping the rest cannot change any in-window pixel).
    """
    if not (0 <= row0 and row0 + h <= size and 0 <= col0
            and col0 + w <= size and h >= 1 and w >= 1):
        raise ValueError(f"window [{row0}:{row0 + h}, {col0}:{col0 + w}] "
                         f"out of bounds for size {size}")
    img = np.empty((h, w), np.float32)
    for k in range(h):
        rng = np.random.default_rng(
            np.random.SeedSequence([77, image_id, 0, row0 + k]))
        row = rng.normal(sky, read_noise, size=size).astype(np.float32)
        img[k] = row[col0:col0 + w]

    a, xy, sig = star_params(image_id, size, density=density,
                             amp_min=amp_min, amp_max=amp_max)
    half = stamp // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float32)
    iy_all = xy[:, 0].astype(np.int64)
    ix_all = xy[:, 1].astype(np.int64)
    hit = ((iy_all + half >= row0) & (iy_all - half < row0 + h)
           & (ix_all + half >= col0) & (ix_all - half < col0 + w))
    for i in np.flatnonzero(hit):
        cy, cx = xy[i]
        iy, ix = int(cy), int(cx)
        dy, dx = cy - iy, cx - ix
        g = a[i] * np.exp(-(((yy - dy) ** 2 + (xx - dx) ** 2)
                            / (2.0 * sig[i] ** 2)))
        y0 = max(row0, max(0, iy - half))
        y1 = min(row0 + h, min(size, iy + half + 1))
        x0 = max(col0, max(0, ix - half))
        x1 = min(col0 + w, min(size, ix + half + 1))
        if y0 >= y1 or x0 >= x1:
            continue
        gy0, gx0 = y0 - (iy - half), x0 - (ix - half)
        img[y0 - row0:y1 - row0, x0 - col0:x1 - col0] += \
            g[gy0:gy0 + (y1 - y0), gx0:gx0 + (x1 - x0)]
    return img


def generate_image(image_id: int, size: int = 1024, **kwargs) -> np.ndarray:
    """Deterministic synthetic star field, float32 (size, size) — the
    full-frame special case of :func:`generate_window`."""
    return generate_window(image_id, 0, 0, size, size, size=size, **kwargs)


def _host_array(img) -> np.ndarray:
    """A numpy array, or a host tensor as one; bfloat16 widens to float32,
    which is what ``img - med`` promotes a numpy bfloat16 array to."""
    if isinstance(img, torch.Tensor):
        return (img.float() if img.dtype == torch.bfloat16 else img).numpy()
    return img


def _median(img) -> float:
    """``np.median`` as the reference takes it.  A bfloat16 tensor
    (bfloat16 has no numpy dtype without ``ml_dtypes``) keeps bfloat16
    arithmetic: numpy averages the two middle values of an even count in
    bfloat16, so their mean is rounded to bfloat16."""
    if isinstance(img, torch.Tensor) and img.dtype == torch.bfloat16:
        s = img.flatten().sort().values
        m = s.numel() // 2
        return float(s[m] if s.numel() % 2 else (s[m - 1] + s[m]) / 2)
    return float(np.median(_host_array(img)))


def estimate_threshold(img, n_sigma: float = 2.0) -> float:
    """Per-image background threshold (median + n_sigma * MAD-sigma), the
    paper's Variant-2 'threshold acquired with each image'.  ``img`` is a
    numpy array or a host tensor (bfloat16 included)."""
    med = _median(img)
    mad = float(np.median(np.abs(_host_array(img) - med)))
    return med + n_sigma * 1.4826 * mad


FILTER_FACTORS = {"vanilla": None, "filter_light": 0.3, "filter_std": 1.0,
                  "filter_heavy": 1.3}


def _level_name(level) -> str:
    """Accept a plain string or a ``FilterLevel`` enum member."""
    name = getattr(level, "value", level)
    if name not in FILTER_FACTORS:
        raise ValueError(f"unknown filter level {level!r}; expected one of "
                         f"{sorted(FILTER_FACTORS)}")
    return name


def filter_threshold(img, level) -> tuple[float | None, float]:
    """Variant 2: per-image exclusion threshold.

    Returns (truncate_value or None, dropped pixel fraction).  The threshold
    is passed to ``pixhomology(..., truncate_value=t)`` which *excludes*
    sub-threshold pixels from the analysis algorithmically (births dropped,
    merges skipped, survivors truncated at t) — closer to the paper's
    "background pixels excluded from the subsequent analysis" than mutating
    the image would be.
    """
    factor = FILTER_FACTORS[_level_name(level)]
    if factor is None:
        return None, 0.0
    t = estimate_threshold(img) * factor
    return float(t), float((_host_array(img) < t).mean())


def estimate_cost(img: np.ndarray, level="filter_std") -> float:
    """Variant 3 LPT cost proxy: number of non-background pixels."""
    factor = FILTER_FACTORS[_level_name(level)] or 1.0
    t = estimate_threshold(img) * factor
    return float((img >= t).sum())


def estimate_cost_from_id(image_id: int, size: int) -> float:
    """Schedule-time cost estimate without rendering the frame: the number
    of above-background pixels scales with sum_i sigma_i^2 log(A_i / noise)
    (area of each Gaussian above the ~5-sigma noise floor)."""
    a, _, sig = star_params(image_id, size)
    visible = a > 25.0
    return float(np.sum(2 * np.pi * sig[visible] ** 2
                        * np.log(np.maximum(a[visible] / 25.0, 1.0 + 1e-6))))


class FrameSequence:
    """Deterministic survey stream over one base star field: frame 0 is
    the base frame, each later frame adds localized Gaussian transients
    confined to a chosen subset of tiles — the workload
    :meth:`repro_torch.ph.PHEngine.run_delta` exists for.

    ``dirty_frac`` controls how many of the ``grid`` tiles each frame
    touches (at least one).  Transient stamps are placed at least
    ``stamp // 2 + 2`` pixels inside their tile, so with halo-padded tile
    hashing *exactly* the chosen tiles change (the stamp never reaches a
    neighbor's halo window); :meth:`dirty_tiles` returns the intended set
    for a frame so tests and benchmarks can assert the delta layer's
    classification against ground truth.  Everything is deterministic in
    ``(image_id, frame index)``.
    """

    def __init__(self, image_id: int, size: int = 1024, *,
                 grid: tuple[int, int] = (4, 4), dirty_frac: float = 0.1,
                 amp: float = 2000.0, stamp: int = 15, **gen_kwargs):
        gr, gc = int(grid[0]), int(grid[1])
        if size % gr or size % gc:
            raise ValueError(f"grid {grid} does not divide size {size}")
        margin = stamp // 2 + 2
        if size // gr <= 2 * margin or size // gc <= 2 * margin:
            raise ValueError(f"tiles {size // gr}x{size // gc} too small "
                             f"for stamp {stamp} with a 2px halo margin")
        if not 0.0 <= dirty_frac <= 1.0:
            raise ValueError(f"dirty_frac must be in [0, 1], "
                             f"got {dirty_frac}")
        self.image_id = int(image_id)
        self.size = int(size)
        self.grid = (gr, gc)
        self.dirty_frac = float(dirty_frac)
        self.amp = float(amp)
        self.stamp = int(stamp)
        self.gen_kwargs = gen_kwargs
        self._base: np.ndarray | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.size, self.size)

    def base(self) -> np.ndarray:
        """The shared frame-0 star field (rendered once, then reused)."""
        if self._base is None:
            self._base = generate_image(self.image_id, self.size,
                                        **self.gen_kwargs)
        return self._base

    def dirty_tiles(self, i: int) -> np.ndarray:
        """Row-major tile indices frame ``i`` perturbs (empty for frame
        0); ``ceil(dirty_frac * n_tiles)`` of them, at least one."""
        if i == 0:
            return np.empty(0, np.int64)
        gr, gc = self.grid
        n_tiles = gr * gc
        n_dirty = max(1, int(np.ceil(self.dirty_frac * n_tiles)))
        rng = np.random.default_rng(
            np.random.SeedSequence([77, self.image_id, 5, i]))
        return np.sort(rng.choice(n_tiles, size=min(n_dirty, n_tiles),
                                  replace=False))

    def frame(self, i: int) -> np.ndarray:
        """Frame ``i``: the base field plus one transient per dirty tile,
        each strictly interior to its tile (see class docstring)."""
        img = self.base().copy()
        if i == 0:
            return img
        gr, gc = self.grid
        tr, tc = self.size // gr, self.size // gc
        half = self.stamp // 2
        margin = half + 2
        yy, xx = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float32)
        rng = np.random.default_rng(
            np.random.SeedSequence([77, self.image_id, 6, i]))
        for t in self.dirty_tiles(i):
            r0, c0 = (int(t) // gc) * tr, (int(t) % gc) * tc
            cy = r0 + rng.integers(margin, tr - margin)
            cx = c0 + rng.integers(margin, tc - margin)
            sig = rng.uniform(1.0, 2.5)
            a = self.amp * rng.uniform(0.5, 1.5)
            g = a * np.exp(-((yy ** 2 + xx ** 2) / (2.0 * sig ** 2)))
            img[cy - half:cy + half + 1, cx - half:cx + half + 1] += g
        return img

    def frames(self, n: int):
        """Generator of the first ``n`` frames (feeds
        ``PHEngine.run_sequence``)."""
        for i in range(n):
            yield self.frame(i)


class AstroImage:
    """Windowed Variant-1 loader for one synthetic frame (a tile provider).

    Nothing is rendered at construction; each :meth:`window` /
    :meth:`halo_tile` call materializes only the pixels it returns, so an
    executor that owns a few tiles of an oversized image never holds the
    frame — the streaming pipeline's residency guarantee.  Satisfies the
    tile-provider protocol of :func:`repro_torch.core.tiling.load_tile_stacks`
    (``shape`` / ``dtype`` / ``halo_tile``).
    """

    dtype = np.float32

    def __init__(self, image_id: int, size: int = 1024, **gen_kwargs):
        self.image_id = int(image_id)
        self.size = int(size)
        self.gen_kwargs = gen_kwargs

    @property
    def shape(self) -> tuple[int, int]:
        return (self.size, self.size)

    def window(self, row0: int, col0: int, h: int, w: int) -> np.ndarray:
        return generate_window(self.image_id, row0, col0, h, w,
                               size=self.size, **self.gen_kwargs)

    def halo_tile(self, t: int, grid: tuple[int, int], *,
                  fill: float = -np.inf) -> np.ndarray:
        """Tile ``t`` (row-major) of the ``(gr, gc)`` grid with its 1-pixel
        halo; halo pixels outside the frame are ``fill`` (matching
        ``repro_torch.core.tiling.split_tiles``)."""
        gr, gc = grid
        th, tw = self.size // gr, self.size // gc
        r0, c0 = (t // gc) * th, (t % gc) * tw
        out = np.full((th + 2, tw + 2), fill, np.float32)
        ry0, ry1 = max(0, r0 - 1), min(self.size, r0 + th + 1)
        rx0, rx1 = max(0, c0 - 1), min(self.size, c0 + tw + 1)
        win = self.window(ry0, rx0, ry1 - ry0, rx1 - rx0)
        out[ry0 - (r0 - 1):ry1 - (r0 - 1),
            rx0 - (c0 - 1):rx1 - (c0 - 1)] = win
        return out

    def filter_threshold(self, level, *, sample: int = 256) -> float | None:
        """Variant-2 threshold estimated on a centered ``sample``-square
        window (O(sample²) resident, deterministic) — the whole-frame
        statistic would defeat windowed loading for oversized images."""
        factor = FILTER_FACTORS[_level_name(level)]
        if factor is None:
            return None
        s = min(self.size, sample)
        off = (self.size - s) // 2
        return float(estimate_threshold(self.window(off, off, s, s))
                     * factor)

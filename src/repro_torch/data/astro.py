"""Synthetic astronomical images (paper §6.2) and their thresholds.

The port's own copy of the frame recipe in ``repro.data.astro``:

  image = sky + N(0, read_noise) + sum_i A_i * G(sigma_i, x_i, y_i)

with power-law star amplitudes and PSF sigmas ~ U(1, 2.5) px, about 3.4
objects per kilopixel².  The read noise is seeded per row, so
:func:`generate_window` renders any window bit-identically to the same
slice of :func:`generate_image`.  Frames are bit-identical to the
reference package's for the same ``image_id`` and ``size`` (the tests hold
them equal), and :func:`filter_threshold` gives the Variant-2 threshold
of a filter level.
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

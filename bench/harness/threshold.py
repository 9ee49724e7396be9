"""The Variant-2 background statistic (PixHomology Table 1), the
benchmark's frozen copy: ``factor * (median + n_sigma * 1.4826 * MAD)``,
with numpy's median (the mean of the two middle values of an even
count), taken on the device and rounded to float32, the dtype the
program compares pixels with."""
from __future__ import annotations

import numpy as np
import torch


def _median(x: torch.Tensor) -> float:
    s = torch.sort(x.reshape(-1)).values
    m = s.numel() // 2
    if s.numel() % 2:
        return float(s[m])
    return (float(s[m - 1]) + float(s[m])) / 2.0


def variant2(frame: torch.Tensor, factor: float, n_sigma: float) -> float:
    """The threshold of one frame, as a float32 value in a Python float."""
    med = _median(frame)
    mad = _median((frame - np.float32(med)).abs())
    return float(np.float32(factor * (med + n_sigma * 1.4826 * mad)))


def thresholds(frames: torch.Tensor, spec: dict | None) -> list | None:
    """Per-frame thresholds for the mix's ``threshold`` entry, or None
    (the vanilla diagram)."""
    if spec is None:
        return None
    if spec["statistic"] != "variant2":
        raise ValueError(f"unknown statistic {spec['statistic']!r}")
    return [variant2(f, float(spec["factor"]), float(spec["n_sigma"]))
            for f in frames]

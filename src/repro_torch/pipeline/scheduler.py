"""Shape buckets for padded dispatches.

Counterpart of the ``bucket_shape`` part of ``repro.pipeline.scheduler``;
the rest of the scheduler (LPT rounds, dataset normalization) comes with
the distributed pipeline.
"""
from __future__ import annotations


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def bucket_shape(shape: tuple[int, int], rounding: str = "pow2"
                 ) -> tuple[int, int]:
    """The padded bucket an image shape schedules under."""
    if rounding == "exact":
        return tuple(shape)
    if rounding == "pow2":
        return (_next_pow2(shape[0]), _next_pow2(shape[1]))
    raise ValueError(f"unknown bucket rounding {rounding!r}")

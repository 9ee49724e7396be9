"""Packed (value, index) merge keys: the rank-free phase-C total order.

Counterpart of ``repro.core.packed_keys``.  :func:`monotone_key32` maps a
<= 32-bit value to an order-isomorphic ``int32`` (sign-corrected bit-cast
for floats, signed zeros canonicalized first); :func:`pack_keys` packs
``(key32 << 32) | (flat_index + 1)`` into an ``int64`` that is
order-isomorphic to the strict total order ``(value, flat_index)``.  The
``+1`` reserves low word 0, so int64 min is a pad sentinel strictly below
every real key.

PyTorch has native int64, so ``merge_keys="packed"`` resolves to packed
keys for every dtype of 32 bits or fewer; there is no scope to open and
no fallback to ranks.  Ranks remain selectable explicitly.

NaNs are outside the contract (:func:`check_finite` rejects them).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import telemetry

MERGE_KEYS = ("packed", "rank")
FILTRATIONS = ("superlevel", "sublevel")

_LOW32 = 0xFFFFFFFF
_PACKABLE = (torch.uint8, torch.int8, torch.int16, torch.int32,
             torch.float16, torch.bfloat16, torch.float32)


def resolve_filtration(filtration: str) -> str:
    """Validate a ``filtration`` request (superlevel or sublevel)."""
    if filtration not in FILTRATIONS:
        raise ValueError(f"filtration must be one of {FILTRATIONS}, "
                         f"got {filtration!r}")
    return filtration


def filtration_view(values: torch.Tensor, filtration: str) -> torch.Tensor:
    """Map values between user space and the internal superlevel order.

    Sublevel is exact negation at the boundary (IEEE sign flips are
    bit-exact and order-reversing); integer images are rejected because
    negation overflows at the dtype minimum.
    """
    resolve_filtration(filtration)
    if filtration == "superlevel":
        return values
    if not values.dtype.is_floating_point:
        raise ValueError(
            f"filtration='sublevel' requires a floating dtype (negation "
            f"of {values.dtype} overflows at the minimum); cast the image "
            f"to a float dtype first")
    return -values


def check_finite(values, where: str = "image", *, allow_inf: bool = False):
    """Reject non-finite pixels at a public boundary (shared message).

    NaN admits no filtration order; ``±inf`` collides with the pad
    sentinels and is rejected unless ``allow_inf``.  Accepts numpy arrays
    and tensors.  One min/max reduction answers both questions (NaN
    propagates into both ends, an infinity is one of them) with no
    temporary the size of the input; a tensor on the card costs one
    readback.  Returns ``values`` unchanged.
    """
    with telemetry.span("check_finite"):
        if isinstance(values, torch.Tensor):
            if not values.dtype.is_floating_point or values.numel() == 0:
                return values
            telemetry.readback(values.device)
            lo, hi = torch.stack(torch.aminmax(values)).tolist()
        else:
            arr = np.asarray(values)
            if arr.dtype.kind != "f" or arr.size == 0:
                return values
            lo, hi = float(np.min(arr)), float(np.max(arr))
    has_nan = math.isnan(lo) or math.isnan(hi)
    has_inf = not allow_inf and (math.isinf(lo) or math.isinf(hi))
    if has_nan:
        raise ValueError(
            f"non-finite pixel(s) in {where}: NaN values cannot be "
            f"ordered by a filtration; mask or clean the image before "
            f"calling")
    if has_inf:
        raise ValueError(
            f"non-finite pixel(s) in {where}: infinite values collide "
            f"with the inert pad sentinels; mask or clean the image "
            f"before calling")
    return values


def packable_dtype(dtype: torch.dtype) -> bool:
    """True when ``dtype`` values fit the 32-bit monotone key map."""
    return dtype in _PACKABLE


def resolve_merge_keys(requested: str, dtype: torch.dtype) -> str:
    """Resolve a ``merge_keys`` request: ``"packed"`` stays packed for every
    dtype of 32 bits or fewer and becomes ``"rank"`` only above that."""
    if requested not in MERGE_KEYS:
        raise ValueError(f"merge_keys must be one of {MERGE_KEYS}, "
                         f"got {requested!r}")
    if requested == "packed" and packable_dtype(dtype):
        return "packed"
    return "rank"


def key_pad(dtype: torch.dtype) -> int:
    """Sentinel at or below every valid key of ``dtype`` (int32 ranks are
    >= 0, packed keys of real pixels have a low word >= 1)."""
    return torch.iinfo(dtype).min


def key_top(dtype: torch.dtype) -> int:
    """Sentinel >= every valid key of ``dtype`` (directional stencil fill)."""
    return torch.iinfo(dtype).max


def monotone_key32(values: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic ``int32`` key of <= 32-bit values (any shape).

    Floats use the sign-corrected bit-cast: non-negative patterns are
    already ascending, negative ones get their low 31 bits flipped.
    ``-0.0`` is canonicalized through the backend's own equality, so key
    equality matches comparison equality.
    """
    if not packable_dtype(values.dtype):
        raise ValueError(f"dtype {values.dtype} does not fit 32-bit "
                         f"monotone keys")
    if not values.dtype.is_floating_point:
        return values.to(torch.int32)
    v = values.to(torch.float32)
    v = torch.where(v == 0, torch.zeros_like(v), v)   # -0.0 ties +0.0
    u = v.view(torch.int32)
    return torch.where(u < 0, u ^ 0x7FFFFFFF, u)


def pack_keys(values_flat: torch.Tensor,
              index_flat: torch.Tensor | None = None) -> torch.Tensor:
    """``(monotone_key32(v) << 32) | (index + 1)`` as int64 (flat arrays).

    The shift is written as a product by 2**32, which cannot overflow for
    an int32 high word.  ``index_flat`` defaults to the flat position.
    """
    k32 = monotone_key32(values_flat)
    if index_flat is None:
        index_flat = torch.arange(values_flat.shape[-1], dtype=torch.int64,
                                  device=values_flat.device)
    low = (index_flat.to(torch.int64) + 1) & _LOW32
    return k32.to(torch.int64) * (1 << 32) + low


def packed_index(keys: torch.Tensor) -> torch.Tensor:
    """Recover the flat index from packed keys (pad sentinel maps to -1)."""
    return ((keys & _LOW32) - 1).to(torch.int32)


def select_descending(key_flat: torch.Tensor, mask_flat: torch.Tensor,
                      k: int, width: int = 2
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` masked keys in descending order: ``(keys, indices)``.

    Blockwise tournament (each round keeps the per-block top-k of
    ``width * k``-wide blocks) with the same selected set and order as a
    full-array top-k, including under overflow.  Lanes beyond the number
    of set entries return the pad key and index -1.  Selects along the
    last axis; leading axes are batch axes, each row giving the bits the
    1-D call gives it.
    """
    n = key_flat.shape[-1]
    lead = tuple(key_flat.shape[:-1])
    k = min(k, n)
    if width < 2:
        raise ValueError(f"tournament width must be >= 2, got {width}")
    pad = key_pad(key_flat.dtype)
    keys = torch.where(mask_flat, key_flat, torch.full_like(key_flat, pad))
    ids = torch.arange(n, dtype=torch.int32,
                       device=key_flat.device).expand(*lead, n)
    block = width * k
    while keys.shape[-1] > block:
        length = keys.shape[-1]
        m = -(-length // block)
        extra = m * block - length
        if extra:
            keys = torch.cat([keys, keys.new_full((*lead, extra), pad)], -1)
            ids = torch.cat([ids, ids.new_full((*lead, extra), -1)], -1)
        top, order = torch.topk(keys.reshape(*lead, m, block), k, dim=-1)
        keys = top.reshape(*lead, m * k)
        ids = torch.gather(ids.reshape(*lead, m, block), -1,
                           order).reshape(*lead, m * k)
    top, order = torch.topk(keys, k, dim=-1)
    return top, torch.where(top > pad, torch.gather(ids, -1, order),
                            -1).to(torch.int32)


def masked_top_k(key_flat: torch.Tensor, mask_flat: torch.Tensor,
                 k: int, width: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Descending top-``k`` of the masked keys: ``(keys, positions)``.

    Packed int64 keys go through the tournament (:func:`select_descending`),
    int32 ranks through one full-array top-k.  Lanes beyond the number of
    set entries carry the pad key and an in-range position — consumers
    must mask on ``keys > key_pad(...)``.  Selects along the last axis
    (leading axes are batch axes).
    """
    if key_flat.dtype == torch.int64:
        top, idx = select_descending(key_flat, mask_flat, k, width)
        return top, torch.clamp(idx, min=0)
    masked = torch.where(mask_flat, key_flat,
                         torch.full_like(key_flat, key_pad(key_flat.dtype)))
    top, idx = torch.topk(masked, min(k, key_flat.shape[-1]), dim=-1)
    return top, idx.to(torch.int32)

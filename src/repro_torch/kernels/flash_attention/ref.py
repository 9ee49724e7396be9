"""Plain PyTorch version of flash attention (the kernel's oracle).

Counterpart of ``repro.kernels.flash_attention.ref``: materialized softmax
attention with grouped-query heads, causal and local-window masks.
Layout: q (B, H, Sq, hd); k/v (B, KV, Skv, hd), query head ``h`` reading
KV head ``h // (H // KV)``.  Scores and the softmax are float32 (inputs
widened first, which is exact for bfloat16); the probabilities are cast
to v's dtype before the product with v, as the reference does.
``q_offset`` places query row ``i`` at position ``i + q_offset`` (a block
of a longer query sequence: a rank's rows on a mesh whose ``model`` axis
splits the sequence).  A row whose keys are all masked gives 0, as the
Pallas kernel's does (the reference's softmax would give NaN there).

This is the CPU path, the backward's recompute, and the version the CUDA
kernel (``kernel.py``) is held to on the card.
"""
from __future__ import annotations

import torch


def mask(sq: int, skv: int, *, causal: bool, window: int | None,
         q_offset: int = 0, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: key ``j`` is visible to query ``i``, which sits at
    position ``i + q_offset``."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    q5 = q.reshape(b, kvh, g, sq, hd)
    s = torch.einsum("bngqd,bnkd->bngqk", q5.float(), k.float())
    s = s * (hd ** -0.5)
    visible = mask(sq, skv, causal=causal, window=window,
                   q_offset=q_offset, device=q.device)
    s = torch.where(visible, s, float("-inf"))
    p = torch.where(visible, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)

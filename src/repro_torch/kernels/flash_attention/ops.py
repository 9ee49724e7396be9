"""Public flash attention op: the CUDA forward, a recompute backward.

``flash_attention(q, k, v, causal=..., window=...)`` in the reference op's
layout: q (B, H, Sq, hd), k/v (B, KV, Skv, hd).  A CUDA tensor runs the
hand-written kernel (``kernel.py``) unless the caller passes
``plain=True``, which selects the plain version explicitly (what the
on-card comparison runs).  A CPU tensor runs the plain version
(``ref.py``).  There is no fallback from the kernel to the plain version:
a kernel that fails to build or launch raises.

The gradient is a ``torch.autograd.Function`` whose backward recomputes
attention through the plain version and differentiates it, as the
reference's ``custom_vjp`` does (there is no backward kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def _forward(q, k, v, causal, window):
    if q.is_cuda:
        return kernel.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
    return ref.attention(q, k, v, causal=causal, window=window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.attention(*inputs, causal=ctx.causal,
                                window=ctx.window)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None, *,
                    plain: bool = False) -> torch.Tensor:
    """Attention of q (B, H, Sq, hd) over k, v (B, KV, Skv, hd), grouped
    query heads sharing KV head ``h // (H // KV)``; returns (B, H, Sq, hd)
    in q's dtype."""
    if plain:
        return ref.attention(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q, k, v, causal, window)

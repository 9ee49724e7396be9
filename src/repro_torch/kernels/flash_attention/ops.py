"""Public flash attention op: the CUDA forward, a recompute backward.

``flash_attention(q, k, v, causal=..., window=...)`` in the reference op's
layout: q (B, H, Sq, hd), k/v (B, KV, Skv, hd).  The route is decided by
device and shape before anything launches:

* a CUDA tensor whose head dim the kernel takes (``kernel.HEAD_DIMS``:
  64, 128, 256) runs the hand-written kernel (``kernel.py``);
* a CUDA tensor of any other head dim runs the plain version
  (``ref.py``), as the reference sends such shapes to its blockwise XLA
  path instead of its kernel (``_flash_kernel_ok``);
* a CPU tensor runs the plain version;
* ``plain=True`` selects the plain version explicitly (what the on-card
  comparison runs).

There is no fallback from the kernel to the plain version: a kernel that
fails to build or launch raises, and the kernel's own checks still raise
when it is called directly with a head dim it does not take.

The gradient is a ``torch.autograd.Function`` whose backward recomputes
attention through the plain version and differentiates it, as the
reference's ``custom_vjp`` does (there is no backward kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def kernel_route(q: torch.Tensor) -> bool:
    """Whether ``flash_attention`` sends ``q`` (and its k, v) to the CUDA
    kernel: a CUDA tensor of a head dim the kernel takes."""
    return q.is_cuda and q.shape[-1] in kernel.HEAD_DIMS


def _forward(q, k, v, causal, window):
    if kernel_route(q):
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

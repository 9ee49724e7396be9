"""Public flash attention op: the CUDA forward, a recompute backward.

``flash_attention(q, k, v, causal=..., window=..., q_offset=...)`` in the
reference op's layout: q (B, H, Sq, hd), k/v (B, KV, Skv, hd); query row
``i`` sits at position ``i + q_offset`` (0 but for a rank's block of the
query sequence on a mesh).  The route is decided by device and shape
before anything launches:

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

The kernel is registered as the custom op ``repro_torch::flash_attention_fwd``
with a fake implementation (an empty output of the kernel's layout), so
fake tensors (``launch/dryrun.py``) take the route the card takes without
building or launching anything.  Inside :func:`card_route` the route is
decided by head dim alone, as on the card, whatever the tensors' device
(fake host tensors of a dry run on a machine without a card).

The gradient is a ``torch.autograd.Function`` whose backward recomputes
attention through the plain version and differentiates it, as the
reference's ``custom_vjp`` does (there is no backward kernel).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.flash_attention import kernel, ref


_CARD_ROUTE = False


def kernel_route(q: torch.Tensor) -> bool:
    """Whether ``flash_attention`` sends ``q`` (and its k, v) to the CUDA
    kernel: a CUDA tensor (any tensor inside :func:`card_route`) of a head
    dim the kernel takes."""
    return (q.is_cuda or _CARD_ROUTE) and q.shape[-1] in kernel.HEAD_DIMS


@contextlib.contextmanager
def card_route():
    """Route by head dim alone, as the card does, for fake tensors of
    another device (a dry run's trace); a real host tensor sent to the
    kernel this way raises in the kernel's checks."""
    global _CARD_ROUTE
    before, _CARD_ROUTE = _CARD_ROUTE, True
    try:
        yield
    finally:
        _CARD_ROUTE = before


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _kernel_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int | None,
               q_offset: int) -> torch.Tensor:
    return kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)


@_kernel_op.register_fake
def _(q, k, v, causal, window, q_offset):
    b, h, sq, hd = q.shape
    return q.new_empty((b, sq, h, hd)).transpose(1, 2)


def _forward(q, k, v, causal, window, q_offset=0):
    if kernel_route(q):
        return _kernel_op(q, k, v, causal, window, q_offset)
    return ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return _forward(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.attention(*inputs, causal=ctx.causal,
                                window=ctx.window, q_offset=ctx.q_offset)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None, *,
                    q_offset: int = 0, plain: bool = False) -> torch.Tensor:
    """Attention of q (B, H, Sq, hd) over k, v (B, KV, Skv, hd), grouped
    query heads sharing KV head ``h // (H // KV)``, query row ``i`` at
    position ``i + q_offset``; returns (B, H, Sq, hd) in q's dtype."""
    if plain:
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)

"""Mixture-of-Experts layer on one device.

Counterpart of ``repro.models.moe``.  The reference shards experts over
its ``model`` mesh axis and moves tokens with ``all_to_all`` (full
sequence and prefill) or sums partial outputs with ``psum`` (decode); on
one device both collectives are identities, and the two paths differ only
in their capacity rule.  This module is that single-device math:

* route: float32 router logits, top-k by a stable descending sort (the
  lower expert id first on ties, as ``jax.lax.top_k``); softmax gates
  renormalised over the top k, or sigmoid gates as they are;
* dispatch: (token, slot) pairs grouped by expert first come, first
  served (a stable sort of the flattened expert ids); a pair at or above
  the capacity is dropped and contributes nothing;
* experts: one batched product per weight over the full
  ``(E, capacity, d)`` buffer, zeros in empty slots, with the reference's
  rounding points (float32 gate and up products, ``gate * up`` cast to
  the model's dtype, a float32 down product cast back);
* combine: ``output * gate`` in the model's dtype, each token's k
  contributions added in ascending expert order, which is the order of
  the reference's scatter-add over expert-sorted pairs.  Everything is
  gathered, nothing is scattered with atomics, so the sum is the same
  on every run.

The Switch load-balance loss is returned beside the output.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_type: str = "softmax"    # softmax (renormalized top-k) | sigmoid
    aux_loss_weight: float = 0.01


def moe_shapes(spec: MoESpec) -> dict:
    """Parameter shapes by name, in the reference's order.  The router is
    float32 in every config; the experts take the model's dtype."""
    e, d, f = spec.num_experts, spec.d_model, spec.d_ff
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def expert_capacity(tokens: int, spec: MoESpec, *, decode: bool) -> int:
    """Slots per expert: the floor of T·k·cf/E for the full sequence and
    prefill (the reference's all_to_all path), its ceiling for decode
    (the psum path); at least 1."""
    want = tokens * spec.top_k * spec.capacity_factor
    if decode:
        return max(1, int(-(-want // spec.num_experts)))
    return max(1, int(want / spec.num_experts))


def _route(x_tokens: torch.Tensor, router: torch.Tensor, spec: MoESpec):
    """x_tokens: (T, D) -> (gates (T, k) f32, idx (T, k) int64, probs
    (T, E) f32)."""
    logits = torch.matmul(x_tokens.float(), router.float())
    if spec.router_type == "sigmoid":
        scores = torch.sigmoid(logits)
        gates, idx = _top_k(scores, spec.top_k)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = _top_k(probs, spec.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _top_k(scores: torch.Tensor, k: int):
    """The k largest along the last dim, the lower index first on ties
    (``torch.topk`` promises no order among equal values)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _dispatch_indices(idx: torch.Tensor, spec: MoESpec, capacity: int):
    """Sort-based capacity assignment.

    idx: (T, k) expert ids.  Returns flattened (T*k,) tensors in expert
    order: (token_sorted, slot_sorted, e_sorted, pos, keep), ``pos`` the
    pair's place in its expert's buffer, first come first served by token
    order."""
    t, k = idx.shape
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)          # group by expert
    e_sorted = e_flat[order]
    experts = torch.arange(spec.num_experts, device=idx.device)
    offsets = torch.searchsorted(e_sorted, experts)     # exclusive cumsum
    pos = torch.arange(t * k, device=idx.device) - offsets[e_sorted]
    keep = pos < capacity
    return order // k, order % k, e_sorted, pos, keep


def _expert_ffn(tokens, w_gate, w_up, w_down):
    """tokens: (E, C, D); weights (E, D, F) / (E, F, D)."""
    gate = F.silu(layers.bmm_f32(tokens, w_gate), inplace=True)
    h = gate.mul_(layers.bmm_f32(tokens, w_up)).to(tokens.dtype)
    return layers.bmm_f32(h, w_down).to(tokens.dtype)


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor,
              spec: MoESpec) -> torch.Tensor:
    """Switch-style load-balance loss (float32 scalar)."""
    e = spec.num_experts
    # one_hot(top1) as a comparison: F.one_hot reads its input's range
    # back to the host, a sync per layer.
    top1 = idx[:, :1] == torch.arange(e, device=idx.device)
    f = torch.mean(top1.float(), dim=0)
    p = torch.mean(probs, dim=0)
    return e * torch.sum(f * p) * spec.aux_loss_weight


def moe_apply(p, x: torch.Tensor, spec: MoESpec, *, decode: bool = False):
    """x: (B, S, D).  ``p`` maps the names of :func:`moe_shapes` to
    tensors.  Returns (y (B, S, D) in x's dtype, aux float32 scalar)."""
    b, s, d = x.shape
    e, k = spec.num_experts, spec.top_k
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    cap = expert_capacity(t, spec, decode=decode)

    gates, idx, probs = _route(tokens, p["router"], spec)
    aux = _aux_loss(probs, idx, spec)
    tok_s, slot_s, e_s, pos, _ = _dispatch_indices(idx, spec, cap)

    # Buffer slot (expert, c) takes the pair at sorted place
    # offsets[expert] + c, a kept pair exactly when c < the expert's count.
    experts = torch.arange(e, device=x.device)
    first = torch.searchsorted(e_s, experts)
    count = torch.searchsorted(e_s, experts, right=True) - first
    slot = torch.arange(cap, device=x.device)
    at = torch.clamp(first[:, None] + slot, max=t * k - 1)
    filled = (slot < count[:, None])[..., None]
    buf = torch.where(filled, tokens[tok_s[at]], 0)
    outs = _expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    outs = outs.reshape(e * cap, d)

    # Combine, pair by pair in (token, slot) order: a dropped pair reads
    # row 0 with weight 0, as the reference's does.
    pair_pos = torch.empty_like(pos).scatter_(0, tok_s * k + slot_s, pos)
    pair_keep = pair_pos < cap
    src = torch.where(pair_keep, idx.reshape(-1) * cap + pair_pos, 0)
    weight = torch.where(pair_keep, gates.reshape(-1), 0.0).to(x.dtype)
    contrib = (outs[src] * weight[:, None]).view(t, k, d)
    by_expert = torch.argsort(idx, dim=1)
    contrib = torch.gather(contrib, 1,
                           by_expert[..., None].expand(t, k, d))
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux

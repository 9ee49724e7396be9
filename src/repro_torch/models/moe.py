"""Mixture-of-Experts layer, on one device or expert-parallel on a mesh.

Counterpart of ``repro.models.moe``.  The experts split over the
``model`` axis of a mesh, with the reference's two paths
(``moe_apply(..., lay=...)``):

* the all_to_all path (train and prefill when ``model`` splits the
  sequence): each rank routes its block of the sequence, sends each
  expert's capacity buffer to the expert's rank and gets the outputs
  back by a second all_to_all; capacity is the floor over the rank's
  tokens;
* the psum path (decode, or a sequence ``model`` does not split): each
  rank routes all its tokens, runs its own experts on them and the ranks
  all-reduce their contributions; capacity is the ceiling.

The aux loss is averaged over the ranks (over ``model`` here; the loss
averages it over the data axes).  Without a mesh (or on one rank) both
collectives are identities and the two paths differ only in their
capacity rule.  The math of one rank:

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

from repro_torch.distributed import parallel
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


def _buffer(tokens, e_s, tok_s, cap: int, e_lo: int, e_hi: int):
    """(e_hi - e_lo, cap, d): buffer slot (expert, c) takes the pair at
    sorted place offsets[expert] + c, a kept pair exactly when c < the
    expert's count; zeros elsewhere."""
    tk = e_s.shape[0]
    experts = torch.arange(e_lo, e_hi, device=tokens.device)
    first = torch.searchsorted(e_s, experts)
    count = torch.searchsorted(e_s, experts, right=True) - first
    slot = torch.arange(cap, device=tokens.device)
    at = torch.clamp(first[:, None] + slot, max=tk - 1)
    filled = (slot < count[:, None])[..., None]
    return torch.where(filled, tokens[tok_s[at]], 0)


def _combine(outs, gates, idx, tok_s, slot_s, pos, cap: int, e_lo: int,
             e_hi: int, dtype):
    """Each token's contributions of experts e_lo .. e_hi - 1 (``outs``:
    their (count * cap, d) outputs), pair by pair in (token, slot) order
    and added in ascending expert order; a dropped pair, or one of another
    expert, reads row 0 with weight 0, as the reference's does."""
    t, k = idx.shape
    d = outs.shape[-1]
    pair_pos = torch.empty_like(pos).scatter_(0, tok_s * k + slot_s, pos)
    e_flat = idx.reshape(-1)
    use = (pair_pos < cap) & (e_flat >= e_lo) & (e_flat < e_hi)
    src = torch.where(use, (e_flat - e_lo) * cap + pair_pos, 0)
    weight = torch.where(use, gates.reshape(-1), 0.0).to(dtype)
    contrib = (outs[src] * weight[:, None]).view(t, k, d)
    by_expert = torch.argsort(idx, dim=1)
    contrib = torch.gather(contrib, 1, by_expert[..., None].expand(t, k, d))
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def moe_apply(p, x: torch.Tensor, spec: MoESpec, *, decode: bool = False,
              lay=None):
    """x: (B, S, D).  ``p`` maps the names of :func:`moe_shapes` to
    tensors.  Returns (y (B, S, D) in x's dtype, aux float32 scalar).
    With ``lay`` (a mesh), ``x`` is the rank's residual stream and the
    reference's route picks the path: the psum path for decode or a
    sequence that ``model`` does not split, the all-to-all path
    otherwise."""
    if lay is not None:
        s = x.shape[1] * (lay.tp if lay.seq else 1)
        if decode or s % lay.tp or s < lay.tp:
            return _psum_path(p, x, spec, lay)
        return _a2a_path(p, x, spec, lay)
    b, s, d = x.shape
    e = spec.num_experts
    tokens = x.reshape(b * s, d)
    cap = expert_capacity(tokens.shape[0], spec, decode=decode)

    gates, idx, probs = _route(tokens, p["router"], spec)
    aux = _aux_loss(probs, idx, spec)
    tok_s, slot_s, e_s, pos, _ = _dispatch_indices(idx, spec, cap)
    buf = _buffer(tokens, e_s, tok_s, cap, 0, e)
    outs = _expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    y = _combine(outs.reshape(e * cap, d), gates, idx, tok_s, slot_s, pos,
                 cap, 0, e, x.dtype)
    return y.reshape(b, s, d), aux


def _experts(p, lay):
    """The rank's experts' weights (experts split over ``model``)."""
    e = p["w_gate"].shape[0]
    if e % lay.tp:
        raise ValueError(f"{e} experts do not split over {lay.tp} ranks of "
                         f"the expert-parallel axis")
    return tuple(lay.weight(p[n], 0) for n in ("w_gate", "w_up", "w_down"))


def _a2a_path(p, x, spec: MoESpec, lay):
    """Sequence-split + all_to_all expert parallelism (train / prefill):
    each rank routes its block of the sequence, capacity the floor over
    its own tokens; the buffers go to the experts' ranks and come back by
    all_to_all."""
    xs = lay.to_chunk(x)
    b, s, d = xs.shape
    e, ep = spec.num_experts, lay.tp
    el = e // ep
    tokens = xs.reshape(b * s, d)
    cap = expert_capacity(tokens.shape[0], spec, decode=False)
    wg, wu, wd = _experts(p, lay)
    gates, idx, probs = _route(tokens, lay.weight(p["router"], whole=False),
                               spec)
    aux = parallel.reduce_from(_aux_loss(probs, idx, spec),
                               lay.tp_group) / ep
    tok_s, slot_s, e_s, pos, _ = _dispatch_indices(idx, spec, cap)
    buf = _buffer(tokens, e_s, tok_s, cap, 0, e).reshape(ep, el, cap, d)
    recv = parallel.all_to_all_grad(buf, lay.tp_group)
    # recv[q, j] = rank q's tokens for my local expert j.
    out = _expert_ffn(recv.transpose(0, 1).reshape(el, ep * cap, d),
                      wg, wu, wd)
    send = out.reshape(el, ep, cap, d).transpose(0, 1)
    back = parallel.all_to_all_grad(send, lay.tp_group)
    y = _combine(back.reshape(e * cap, d), gates, idx, tok_s, slot_s, pos,
                 cap, 0, e, x.dtype)
    return lay.from_chunk(y.reshape(b, s, d)), aux


def _psum_path(p, x, spec: MoESpec, lay):
    """Local experts + all-reduce (decode, or a sequence ``model`` does not
    split): every rank routes every token of its batch, capacity the
    ceiling over them, runs its own experts and the ranks sum their
    contributions."""
    b, s, d = x.shape
    e, ep = spec.num_experts, lay.tp
    el = e // ep
    lo = lay.tp_rank * el
    tokens = x.reshape(b * s, d)
    cap = expert_capacity(tokens.shape[0], spec, decode=True)
    wg, wu, wd = _experts(p, lay)
    gates, idx, probs = _route(tokens, lay.weight(p["router"]), spec)
    aux = _aux_loss(probs, idx, spec)
    tok_s, slot_s, e_s, pos, _ = _dispatch_indices(idx, spec, cap)
    group = lay.tp_group
    buf = _buffer(parallel.copy_to(tokens, group), e_s, tok_s, cap, lo,
                  lo + el)
    out = _expert_ffn(buf, wg, wu, wd)
    y = _combine(out.reshape(el * cap, d), parallel.copy_to(gates, group),
                 idx, tok_s, slot_s, pos, cap, lo, lo + el, x.dtype)
    return parallel.reduce_from(y, group).reshape(b, s, d), aux

"""Attention: GQA/MQA/MHA with RoPE, qk-norm, local windows, KV-cache decode.

Counterpart of ``repro.models.attention``.  Full-sequence attention
(``apply_attention``, and ``prefill_attention`` over the prompt) goes
through the one flash attention op (``kernels/flash_attention``): on a
CUDA tensor the hand-written kernel where it takes the head dim (64, 128,
256) and the plain version elsewhere, on the CPU the plain version.  The
reference's blockwise XLA path computes the same contraction; here the
ragged tail is masked in the kernel instead of padded.  One-token decode
contracts the query against the cache with plain tensor ops, as the
reference does.

Layout conventions: activations (B, S, D); q/k/v (B, S, H, hd); KV caches
(B, S_max, Hkv, hd).  Unlike the reference's functional caches, a
:class:`KVCache` is updated in place (prefill writes the prompt's keys and
values, decode writes one slot and advances ``length``), so a decode step
allocates no new cache.  One device: the reference's sharding
constraints (``_constrain_qkv``, ``ctx``) are not carried over.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float | None = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True
    window: int | None = None           # local attention window (None = full)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor      # (B, S_max, Hkv, hd)
    v: torch.Tensor
    length: int          # tokens written so far


def attention_shapes(spec: AttnSpec) -> dict:
    """Parameter shapes by dotted name, in the reference's tree and
    order (``q_norm``/``k_norm`` are ``{"scale": ...}`` norms)."""
    d, h, hk, hd = (spec.d_model, spec.num_heads, spec.num_kv_heads,
                    spec.head_dim)
    shapes = {"wq": (d, h * hd), "wk": (d, hk * hd), "wv": (d, hk * hd),
              "wo": (h * hd, d)}
    if spec.qkv_bias:
        shapes.update({"bq": (h * hd,), "bk": (hk * hd,), "bv": (hk * hd,)})
    if spec.qk_norm:
        shapes.update({"q_norm.scale": (hd,), "k_norm.scale": (hd,)})
    return shapes


def _project_qkv(p, x, positions, spec: AttnSpec):
    b = x.shape[0]
    q = layers.matmul(x, p["wq"])
    k = layers.matmul(x, p["wk"])
    v = layers.matmul(x, p["wv"])
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, -1, spec.num_heads, spec.head_dim)
    k = k.reshape(b, -1, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(b, -1, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = layers.rmsnorm(p["q_norm"]["scale"], q)
        k = layers.rmsnorm(p["k_norm"]["scale"], k)
    if spec.rope_theta is not None:
        q = layers.rope(q, positions, theta=spec.rope_theta)
        k = layers.rope(k, positions, theta=spec.rope_theta)
    return q, k, v


def blockwise_attention(q, k, v, *, causal: bool, window: int | None,
                        plain: bool = False) -> torch.Tensor:
    """Full-sequence attention, q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd),
    positions 0..S-1.  The flash op takes the (B, heads, S, hd) views of
    the same memory; its output view transposes back without a copy."""
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal, window,
                                 plain=plain)
    return out.transpose(1, 2)


def _attend_and_project(p, q, k, v, spec: AttnSpec, plain: bool):
    b, s = q.shape[:2]
    out = blockwise_attention(q, k, v, causal=spec.causal, window=spec.window,
                              plain=plain)
    out = out.reshape(b, s, spec.num_heads * spec.head_dim)
    return layers.matmul(out, p["wo"])


def apply_attention(p, x, *, spec: AttnSpec,
                    plain: bool = False) -> torch.Tensor:
    """Full-sequence self-attention (training / forward without cache)."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, positions, spec)
    return _attend_and_project(p, q, k, v, spec, plain)


def cache_len(max_len: int, spec: AttnSpec) -> int:
    """Physical cache length: local-window layers keep a ring of `window`."""
    return min(max_len, spec.window) if spec.window is not None else max_len


def init_cache(batch: int, max_len: int, spec: AttnSpec, *, dtype,
               device) -> KVCache:
    shape = (batch, cache_len(max_len, spec), spec.num_kv_heads,
             spec.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def prefill_attention(p, x, cache: KVCache, *, spec: AttnSpec,
                      plain: bool = False
                      ) -> tuple[torch.Tensor, KVCache]:
    """Full attention over a prompt, writing (the tail of) K/V into the
    cache in place.

    Ring caches (local-window layers) keep the last `cache_len` tokens, each
    stored at slot ``abs_pos % cache_len`` so decode writes stay aligned.
    """
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, positions, spec)
    c = cache.k.shape[1]
    ktail, vtail = k[:, -c:], v[:, -c:]
    if s >= c and s % c:
        ktail = torch.roll(ktail, s % c, dims=1)
        vtail = torch.roll(vtail, s % c, dims=1)
    n = ktail.shape[1]
    cache.k[:, :n].copy_(ktail)
    cache.v[:, :n].copy_(vtail)
    cache.length = s
    return _attend_and_project(p, q, k, v, spec, plain), cache


def decode_attention(p, x, cache: KVCache, *, spec: AttnSpec
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token self-attention decode against the cache. x: (B, 1, D).

    The query contracts against the filled slots of the cache (masked
    slots carry zero weight in the reference, so leaving them out is the
    same sum), with float32 scores and the probabilities cast to the
    cache's dtype before the product with the values."""
    b = x.shape[0]
    pos = cache.length
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = _project_qkv(p, x, positions, spec)
    c = cache.k.shape[1]
    if spec.window is None and pos >= c:
        raise ValueError(f"KV cache of {c} tokens is full")
    slot = pos % c
    cache.k[:, slot:slot + 1].copy_(k)
    cache.v[:, slot:slot + 1].copy_(v)
    cache.length = pos + 1
    valid = min(pos + 1, c)
    keys, vals = cache.k[:, :valid], cache.v[:, :valid]

    g = spec.num_heads // spec.num_kv_heads
    # GQA-grouped: contract against the cache without repeating K/V.
    q5 = q.reshape(b, spec.num_kv_heads, g, spec.head_dim)
    s = torch.einsum("bngd,bknd->bngk", q5.float(), keys.float())
    s = s * spec.head_dim ** -0.5                    # (B, KV, G, valid)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bngk,bknd->bngd", w.to(vals.dtype).float(),
                       vals.float())
    out = out.reshape(b, 1, spec.num_heads * spec.head_dim).to(x.dtype)
    return layers.matmul(out, p["wo"]), cache

"""Attention: GQA/MQA/MHA with RoPE, qk-norm, local windows, KV-cache decode.

Counterpart of ``repro.models.attention``.  Full-sequence attention
(``apply_attention``, and ``prefill_attention`` over the prompt) goes
through the one flash attention op (``kernels/flash_attention``): on a
CUDA tensor the hand-written kernel where it takes the head dim (64, 128,
256) and the plain version elsewhere, on the CPU the plain version.  The
reference's blockwise XLA path computes the same contraction; here the
ragged tail is masked in the kernel instead of padded.  One-token decode
contracts the query against the cache with plain tensor ops, as the
reference does.  Cross-attention (Whisper's decoder) takes its keys and
values from a source sequence: non-causal over the whole source in full,
against fixed per-layer caches in decode.

Operands of two dtypes are promoted as jnp promotes them before the flash
op (the kernel takes one dtype), and its output is cast to the values'
dtype, where the reference's blockwise path casts it.

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


def _project_q(p, x, positions, spec: AttnSpec):
    q = layers.matmul(x, p["wq"])
    if spec.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(x.shape[0], -1, spec.num_heads, spec.head_dim)
    if spec.qk_norm:
        q = layers.rmsnorm(p["q_norm"]["scale"], q)
    if spec.rope_theta is not None:
        q = layers.rope(q, positions, theta=spec.rope_theta)
    return q


def _project_qkv(p, x, positions, spec: AttnSpec, kv_src=None,
                 kv_positions=None):
    """q from ``x``; k, v from ``kv_src`` (cross-attention, its keys at
    ``kv_positions``) or ``x``."""
    b = x.shape[0]
    kv_in = x if kv_src is None else kv_src
    k = layers.matmul(kv_in, p["wk"])
    v = layers.matmul(kv_in, p["wv"])
    if spec.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, -1, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(b, -1, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        k = layers.rmsnorm(p["k_norm"]["scale"], k)
    if spec.rope_theta is not None:
        k = layers.rope(k, positions if kv_positions is None
                        else kv_positions, theta=spec.rope_theta)
    return _project_q(p, x, positions, spec), k, v


def blockwise_attention(q, k, v, *, causal: bool, window: int | None,
                        plain: bool = False) -> torch.Tensor:
    """Full-sequence attention, q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd),
    positions 0..S-1.  The flash op takes the (B, heads, S, hd) views of
    the same memory; its output view transposes back without a copy.
    q, k and v of two dtypes go in at their promoted dtype, and the
    output comes back in v's dtype, as the reference's does."""
    out_dtype = v.dtype
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = (t.to(dt) for t in (q, k, v))
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal, window,
                                 plain=plain)
    return out.transpose(1, 2).to(out_dtype)


def _attend_and_project(p, q, k, v, spec: AttnSpec, plain: bool,
                        causal: bool):
    b, s = q.shape[:2]
    out = blockwise_attention(q, k, v, causal=causal, window=spec.window,
                              plain=plain)
    out = out.reshape(b, s, spec.num_heads * spec.head_dim)
    return layers.matmul(out, p["wo"])


def apply_attention(p, x, *, spec: AttnSpec, kv_src=None,
                    plain: bool = False) -> torch.Tensor:
    """Full-sequence attention (training / forward without cache): self-
    attention, or with ``kv_src`` (B, S_src, D) non-causal
    cross-attention over the source, its keys at positions 0..S_src-1."""
    positions = torch.arange(x.shape[1], device=x.device)
    kv_positions = None if kv_src is None else torch.arange(
        kv_src.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, positions, spec, kv_src, kv_positions)
    return _attend_and_project(p, q, k, v, spec, plain,
                               spec.causal and kv_src is None)


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
    return _attend_and_project(p, q, k, v, spec, plain, spec.causal), cache


def decode_attention(p, x, cache: KVCache, *, spec: AttnSpec,
                     kv_src_cache: KVCache | None = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the cache. x: (B, 1, D).

    Self-attention writes the token's K/V into ``cache``.  With
    ``kv_src_cache`` it is cross-attention: the keys and values are that
    cache's (the encoder's, fixed, no RoPE on them), the query takes RoPE
    at ``cache.length`` where the spec has it, and ``cache`` comes back
    unchanged.

    The query contracts against the filled slots (masked slots carry zero
    weight in the reference, so leaving them out is the same sum), with
    float32 scores and the probabilities cast to the values' dtype before
    the product with the values; the output takes ``x``'s dtype."""
    b = x.shape[0]
    pos = cache.length
    positions = torch.full((1,), pos, device=x.device)
    if kv_src_cache is None:
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
    else:
        q = _project_q(p, x, positions, spec)
        valid = kv_src_cache.length
        keys = kv_src_cache.k[:, :valid]
        vals = kv_src_cache.v[:, :valid]

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

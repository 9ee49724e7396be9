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
allocates no new cache.

On an LM mesh (a ``parallel.Layout``) each rank runs its share, with the
reference's layout of q/k/v (``_constrain_qkv``): the heads over
``model`` when its size divides the query heads (K/V heads too when it
divides them; otherwise each rank takes the KV heads its q heads read),
else the query sequence over ``model`` against replicated K/V, the rank's
rows at their offset in the sequence (``q_offset``).  The flash op only
ever sees local tensors.  A KV cache there holds the rank's block of the
positions (``cache_specs``: the sequence over ``model``); decode writes a
token on the rank that owns its slot and combines the ranks' partial
softmaxes with all-reduces (flash-decoding).  Cross-attention takes the
same routes, its K/V projected from the source (whole on every rank); in
decode its cache holds the rank's block of the source positions, laid
out by the same rule, and is never written.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import parallel
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
    start: int = 0       # on a mesh: the first slot this rank holds
    group: object = None  # on a mesh: the ranks that split the slots


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


def _project_kv(p, kv_in, positions, spec: AttnSpec):
    b = kv_in.shape[0]
    k = layers.matmul(kv_in, p["wk"])
    v = layers.matmul(kv_in, p["wv"])
    if spec.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, -1, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(b, -1, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        k = layers.rmsnorm(p["k_norm"]["scale"], k)
    if spec.rope_theta is not None:
        k = layers.rope(k, positions, theta=spec.rope_theta)
    return k, v


def _project_qkv(p, x, positions, spec: AttnSpec, kv_src=None,
                 kv_positions=None):
    """q from ``x``; k, v from ``kv_src`` (cross-attention, its keys at
    ``kv_positions``) or ``x``."""
    k, v = _project_kv(p, x if kv_src is None else kv_src,
                       positions if kv_positions is None else kv_positions,
                       spec)
    return _project_q(p, x, positions, spec), k, v


def blockwise_attention(q, k, v, *, causal: bool, window: int | None,
                        plain: bool = False, q_offset: int = 0
                        ) -> torch.Tensor:
    """Full-sequence attention, q: (B, Sq, H, hd), k/v: (B, Skv, Hkv, hd),
    the queries at positions ``q_offset`` .. and the keys at 0 ...  The
    flash op takes the (B, heads, S, hd) views of the same memory; its
    output view transposes back without a copy.
    q, k and v of two dtypes go in at their promoted dtype, and the
    output comes back in v's dtype, as the reference's does."""
    out_dtype = v.dtype
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = (t.to(dt) for t in (q, k, v))
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal, window,
                                 q_offset=q_offset, plain=plain)
    return out.transpose(1, 2).to(out_dtype)


def _attend_and_project(p, q, k, v, spec: AttnSpec, plain: bool,
                        causal: bool):
    b, s = q.shape[:2]
    out = blockwise_attention(q, k, v, causal=causal, window=spec.window,
                              plain=plain)
    out = out.reshape(b, s, spec.num_heads * spec.head_dim)
    return layers.matmul(out, p["wo"])


def apply_attention(p, x, *, spec: AttnSpec, kv_src=None,
                    plain: bool = False, lay=None) -> torch.Tensor:
    """Full-sequence attention (training / forward without cache): self-
    attention, or with ``kv_src`` (B, S_src, D) non-causal
    cross-attention over the source, its keys at positions 0..S_src-1.
    With ``lay`` (a mesh) ``x`` is the rank's residual stream and so is
    the result; ``kv_src`` is whole on every rank."""
    if lay is not None:
        return _mesh_attention(p, x, spec, lay, plain, kv_src=kv_src)[0]
    positions = torch.arange(x.shape[1], device=x.device)
    kv_positions = None if kv_src is None else torch.arange(
        kv_src.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, positions, spec, kv_src, kv_positions)
    return _attend_and_project(p, q, k, v, spec, plain,
                               spec.causal and kv_src is None)


def cache_len(max_len: int, spec: AttnSpec) -> int:
    """Physical cache length: local-window layers keep a ring of `window`."""
    return min(max_len, spec.window) if spec.window is not None else max_len


def slot_block(lay, batch: int, slots: int, spec: AttnSpec):
    """The block of a cache's ``slots`` that this rank holds: (its first
    slot, how many, the group of ranks that split them), all of them
    unless ``lay`` splits them (``cache_specs``: the positions over
    ``model``)."""
    if lay is not None and lay.cache_dim("k", (
            batch, slots, spec.num_kv_heads, spec.head_dim)) == 1:
        n = slots // lay.tp
        return lay.tp_rank * n, n, lay.tp_group
    return 0, slots, None


def init_cache(batch: int, max_len: int, spec: AttnSpec, *, dtype,
               device, lay=None) -> KVCache:
    """Zeros for ``batch`` sequences; with ``lay`` this rank's block of the
    slots (:func:`slot_block`)."""
    start, c, group = slot_block(lay, batch, cache_len(max_len, spec), spec)
    shape = (batch, c, spec.num_kv_heads, spec.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0,
                   start, group)


def _slots(cache: KVCache) -> int:
    """The cache's whole length over the ranks that split it."""
    return cache.k.shape[1] * parallel.group_size(cache.group)


def prefill_attention(p, x, cache: KVCache, *, spec: AttnSpec,
                      plain: bool = False, lay=None
                      ) -> tuple[torch.Tensor, KVCache]:
    """Full attention over a prompt, writing (the tail of) K/V into the
    cache in place.

    Ring caches (local-window layers) keep the last `cache_len` tokens, each
    stored at slot ``abs_pos % cache_len`` so decode writes stay aligned.
    On a mesh each rank writes its block of the slots.
    """
    if lay is not None:
        y, k, v = _mesh_attention(p, x, spec, lay, plain, want_kv=True)
        _write_prompt(cache, k, v)
        return y, cache
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, positions, spec)
    _write_prompt(cache, k, v)
    return _attend_and_project(p, q, k, v, spec, plain, spec.causal), cache


def _write_prompt(cache: KVCache, k, v) -> None:
    """The prompt's K/V (B, S, KV, hd, every position) into the cache: its
    last ``slots`` tokens, each at slot ``pos % slots``; on a mesh the
    rank writes the block of slots it holds (``cache.start`` on)."""
    s = k.shape[1]
    c = _slots(cache)
    ktail, vtail = k[:, -c:], v[:, -c:]
    if s >= c and s % c:
        ktail = torch.roll(ktail, s % c, dims=1)
        vtail = torch.roll(vtail, s % c, dims=1)
    lo = cache.start
    hi = min(lo + cache.k.shape[1], ktail.shape[1])
    if hi > lo:
        cache.k[:, :hi - lo].copy_(ktail[:, lo:hi])
        cache.v[:, :hi - lo].copy_(vtail[:, lo:hi])
    cache.length = s


def _write_token(cache: KVCache, k, v, window: int | None):
    """One token's K/V (B, 1, KV, hd) at position ``cache.length`` into its
    slot, on the rank that holds it; advances ``length``.  Returns this
    rank's filled slots (keys, values)."""
    pos, c, cl = cache.length, _slots(cache), cache.k.shape[1]
    if window is None and pos >= c:
        raise ValueError(f"KV cache of {c} tokens is full")
    at = pos % c - cache.start
    if 0 <= at < cl:
        cache.k[:, at:at + 1].copy_(k)
        cache.v[:, at:at + 1].copy_(v)
    cache.length = pos + 1
    return _filled(cache)


def _filled(cache: KVCache):
    """This rank's filled slots of ``cache`` (keys, values)."""
    n = max(0, min(min(cache.length, _slots(cache)) - cache.start,
                   cache.k.shape[1]))
    return cache.k[:, :n], cache.v[:, :n]


def _attend_cache(q, keys, vals, spec: AttnSpec, group=None):
    """One query token (B, 1, H, hd) against cached keys and values (B, n,
    KV, hd), GQA-grouped without repeating K/V: float32 scores, the
    probabilities cast to the values' dtype before the product.  With
    ``group`` the ranks hold disjoint blocks of the slots and their
    partial softmaxes combine (the maxima, then the sums of the weights
    and of the weighted values).  Returns (B, 1, H * hd) float32."""
    b, nkv, hd = q.shape[0], spec.num_kv_heads, spec.head_dim
    g = spec.num_heads // nkv
    q5 = q.reshape(b, nkv, g, hd)
    sc = torch.einsum("bngd,bknd->bngk", q5.float(), keys.float())
    sc = sc * hd ** -0.5                               # (B, KV, G, n)
    if group is None:
        w = torch.softmax(sc, dim=-1)
    else:
        m = sc.amax(-1) if keys.shape[1] else torch.full(
            sc.shape[:-1], float("-inf"), device=sc.device)
        m = parallel.all_reduce(m, group, torch.distributed.ReduceOp.MAX)
        e = torch.exp(sc - m[..., None])
        w = e / parallel.all_reduce(e.sum(-1), group)[..., None]
    out = torch.einsum("bngk,bknd->bngd", w.to(vals.dtype).float(),
                       vals.float())
    if group is not None:
        out = parallel.all_reduce(out, group)
    return out.reshape(b, 1, spec.num_heads * hd)


def decode_attention(p, x, cache: KVCache, *, spec: AttnSpec,
                     kv_src_cache: KVCache | None = None, lay=None
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
    if lay is not None:
        return _mesh_decode(p, x, cache, spec, lay, kv_src_cache)
    positions = torch.full((1,), cache.length, device=x.device)
    if kv_src_cache is None:
        q, k, v = _project_qkv(p, x, positions, spec)
        keys, vals = _write_token(cache, k, v, spec.window)
    else:
        q = _project_q(p, x, positions, spec)
        keys, vals = _filled(kv_src_cache)
    out = _attend_cache(q, keys, vals, spec).to(x.dtype)
    return layers.matmul(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _local(p, lay, spec: AttnSpec, q, kv, o, *, whole: bool) -> dict:
    """The rank's weights: wq/bq split over ``model`` along ``q`` (None:
    whole), wk/wv/bk/bv along ``kv``, wo along ``o``."""
    def bias(w, dim):
        return lay.weight(w, None if dim is None else 0, whole=whole)

    lp = {"wq": lay.weight(p["wq"], q, whole=whole),
          "wk": lay.weight(p["wk"], kv, whole=whole),
          "wv": lay.weight(p["wv"], kv, whole=whole),
          "wo": lay.weight(p["wo"], o, whole=whole)}
    if spec.qkv_bias:
        lp.update(bq=bias(p["bq"], q), bk=bias(p["bk"], kv),
                  bv=bias(p["bv"], kv))
    if spec.qk_norm:
        for n in ("q_norm", "k_norm"):
            lp[n] = {"scale": lay.weight(p[n]["scale"], None, whole=whole)}
    return lp


def _kv_for_heads(t, spec: AttnSpec, lo: int, hl: int):
    """The KV heads (dim 2 of ``t``, all KV heads) that query heads lo ..
    lo + hl - 1 read, in the flash op's grouping (query head ``h`` of
    ``hl`` reads local KV head ``h // (hl // kv_local)``)."""
    g = spec.num_heads // spec.num_kv_heads
    if g % hl == 0:
        return t[:, :, lo // g:lo // g + 1]
    if hl % g == 0:
        return t[:, :, lo // g:(lo + hl) // g]
    return t[:, :, torch.arange(lo, lo + hl, device=t.device) // g]


def _mesh_attention(p, h, spec: AttnSpec, lay, plain: bool,
                    want_kv: bool = False, kv_src=None):
    """Self-attention of the rank's residual stream ``h`` (B, S or S/tp,
    D), or with ``kv_src`` (B, S_src, D, whole on every rank) non-causal
    cross-attention over the source, its keys at positions 0 ..
    S_src - 1.  Returns (the result on the residual stream, k, v): k and
    v with every KV head over the whole sequence when ``want_kv`` (for
    the cache), else the rank's own."""
    tp, r = lay.tp, lay.tp_rank
    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    b = h.shape[0]
    s = h.shape[1] * (tp if lay.seq else 1)
    causal = spec.causal and kv_src is None
    pos = torch.arange(s, device=h.device)
    kv_pos = pos if kv_src is None else torch.arange(kv_src.shape[1],
                                                     device=h.device)

    def source(full):
        """The K/V input of a product split over ``model``: the whole
        sequence ``full``, or the source entering the split."""
        return full if kv_src is None else parallel.copy_to(kv_src,
                                                            lay.tp_group)

    if nh % tp == 0:
        # heads over ``model`` (Megatron); K/V heads too when they split.
        kv_split = nkv % tp == 0
        hl = nh // tp
        lp = _local(p, lay, spec, 1, 1 if kv_split else None, 0,
                    whole=False)
        lspec = dataclasses.replace(
            spec, num_heads=hl, num_kv_heads=nkv // tp if kv_split else nkv)
        hin = lay.to_full(h)
        q = _project_q(lp, hin, pos, lspec)
        k, v = _project_kv(lp, source(hin), kv_pos, lspec)
        kk, vv = (t if kv_split else _kv_for_heads(t, spec, r * hl, hl)
                  for t in (k, v))
        out = blockwise_attention(q, kk, vv, causal=causal,
                                  window=spec.window, plain=plain)
        y = lay.from_partial(layers.matmul(out.reshape(b, s, hl * hd),
                                           lp["wo"]))
        if want_kv and kv_split:
            k, v = (parallel.all_gather(t, lay.tp_group, 2) for t in (k, v))
        return y, k, v
    if s % tp == 0:
        # the query sequence over ``model`` against replicated K/V.
        lp = _local(p, lay, spec, None, None, None, whole=False)
        hq = lay.to_chunk(h)
        sl = hq.shape[1]
        off = r * sl
        q = _project_q(lp, hq, torch.arange(off, off + sl, device=h.device),
                       spec)
        k, v = _project_kv(lp, source(lay.to_full(h)), kv_pos, spec)
        out = blockwise_attention(q, k, v, causal=causal,
                                  window=spec.window, plain=plain,
                                  q_offset=off if causal else 0)
        y = layers.matmul(out.reshape(b, sl, nh * hd), lp["wo"])
        return lay.from_chunk(y), k, v
    # neither splits: every rank computes the whole attention.
    lp = _local(p, lay, spec, None, None, None, whole=True)
    q, k, v = _project_qkv(lp, h, pos, spec, kv_src, kv_pos)
    out = blockwise_attention(q, k, v, causal=causal, window=spec.window,
                              plain=plain)
    return layers.matmul(out.reshape(b, s, nh * hd), lp["wo"]), k, v


@torch.no_grad()
def _mesh_decode(p, x, cache: KVCache, spec: AttnSpec, lay,
                 kv_src_cache: KVCache | None = None):
    """One-token decode on a mesh: q (and the token's k, v) with every
    head on every rank, the token written on the rank that holds its
    slot, the softmax over the slots combined across the ranks that split
    them (their maxima, then the sums of the weights and of the weighted
    values).  With ``kv_src_cache`` (cross-attention) the keys and values
    are the rank's block of that cache and nothing is written."""
    tp, r = lay.tp, lay.tp_rank
    nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    positions = torch.full((1,), cache.length, device=x.device)
    cross = kv_src_cache is not None
    heads = tp > 1 and nh % tp == 0
    if heads:
        kv_split = nkv % tp == 0
        lp = _local(p, lay, spec, 1, 1 if kv_split else None, 0, whole=True)
        lspec = dataclasses.replace(
            spec, num_heads=nh // tp,
            num_kv_heads=nkv // tp if kv_split else nkv)
        q = parallel.all_gather(_project_q(lp, x, positions, lspec),
                                lay.tp_group, 2)
        if not cross:
            k, v = _project_kv(lp, x, positions, lspec)
            if kv_split:
                k, v = (parallel.all_gather(t, lay.tp_group, 2)
                        for t in (k, v))
    else:
        lp = _local(p, lay, spec, None, None, None, whole=True)
        q = _project_q(lp, x, positions, spec)
        if not cross:
            k, v = _project_kv(lp, x, positions, spec)
    if cross:
        (keys, vals), group = _filled(kv_src_cache), kv_src_cache.group
    else:
        keys, vals = _write_token(cache, k, v, spec.window)
        group = cache.group
    out = _attend_cache(q, keys, vals, spec, group).to(x.dtype)
    if heads:
        hl = nh // tp
        out = out[..., r * hl * hd:(r + 1) * hl * hd]
        return parallel.all_reduce(layers.matmul(out, lp["wo"]),
                                   lay.tp_group), cache
    return layers.matmul(out, lp["wo"]), cache

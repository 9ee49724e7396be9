"""Whisper-style encoder-decoder backbone (arXiv:2212.04356).

Counterpart of ``repro.models.encdec``.  As in the reference, the conv/mel
frontend is a stub: the encoder takes precomputed frame embeddings (B,
S_enc, D), and positions are sinusoidal on both sides.  Encoder:
bidirectional attention + GELU MLP.  Decoder: causal self-attention (with
a KV cache) + cross-attention over the encoder's output (per-layer K/V
caches in decode) + GELU MLP.  The stacks are ``ModuleList``s named
``enc_blocks.{i}`` and ``dec_blocks.{i}``; the reference scans stacked
copies.

Dtypes follow jnp's promotion, as the reference's arithmetic does: with
bfloat16 weights and float32 frames (what ``serve`` passes) the encoder
runs in float32, the cross-attention K/V are float32, and so is the
decoder's residual stream after the first cross-attention of a full
sequence or a prefill; decode casts each attention output to the stream's
dtype, so its stream stays in the embedding's dtype.  (The reference's
layer ``scan`` refuses a carry that changes dtype, so its own ``prefill``
and ``loss_fn`` raise on that input; the port computes the function its
blocks define, layer by layer.)  The logits are not masked past the
vocabulary, as the reference's are not.

``ctx`` (an ``LMContext``) runs ``loss_fn``, ``prefill`` and
``decode_step`` on an LM mesh, the parameters placed by
``sharding.param_specs`` and the batch the rank's share of the data axes.
The reference's encoder-decoder takes ``ctx`` but never constrains its
stream, so here the residual stream stays replicated over ``model``
(``seq_shard`` is not read): the attentions take the routes of
``attention._mesh_attention`` (the encoder's 1500 frames at 16-way
``model`` neither), the GELU MLPs ``layers._mesh_mlp``, the tied
embedding and the cross-entropy and logits split the vocabulary as the
decoder-only LM's do.  The self caches and the cross caches each hold
the rank's block of their positions (``cache_specs``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.models import attention, layers, transformer
from repro_torch.models.transformer import (DTYPES, ParamTree, check_state,
                                            init_leaf, prefixed, unflatten)


def _spec(cfg: ModelConfig, *, causal: bool) -> attention.AttnSpec:
    return attention.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=None, qkv_bias=cfg.qkv_bias, causal=causal)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) float32: [sin | cos] of positions times
    exp(-log(1e4) * i / max(d/2 - 1, 1))."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln_shapes(d: int, prefix: str) -> dict:
    return {f"{prefix}.scale": (d,), f"{prefix}.bias": (d,)}


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape by state-dict name."""
    d = cfg.d_model
    attn = attention.attention_shapes(_spec(cfg, causal=False))
    mlp = layers.mlp_shapes(d, cfg.d_ff, "gelu")
    enc = {**_ln_shapes(d, "norm1"), **prefixed("attn", attn),
           **_ln_shapes(d, "norm2"), **prefixed("mlp", mlp)}
    dec = {**_ln_shapes(d, "norm1"), **prefixed("self_attn", attn),
           **_ln_shapes(d, "norm2"), **prefixed("cross_attn", attn),
           **_ln_shapes(d, "norm3"), **prefixed("mlp", mlp)}
    shapes = {"embed.embedding": (cfg.padded_vocab, d)}
    for i in range(cfg.encoder_layers):
        shapes.update(prefixed(f"enc_blocks.{i}", enc))
    shapes.update(_ln_shapes(d, "enc_final_norm"))
    for i in range(cfg.num_layers):
        shapes.update(prefixed(f"dec_blocks.{i}", dec))
    shapes.update(_ln_shapes(d, "final_norm"))
    return shapes


class EncDec(nn.Module):
    """The encoder-decoder's parameters: ``embed``, ``enc_blocks``,
    ``enc_final_norm``, ``dec_blocks``, ``final_norm``; ``lm_head`` is
    None (the embedding is the head)."""

    def __init__(self, cfg: ModelConfig, state: dict):
        super().__init__()
        tree = unflatten(state)
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.register_parameter("lm_head", None)
        self.enc_blocks = nn.ModuleList(
            ParamTree(tree["enc_blocks"][str(i)])
            for i in range(cfg.encoder_layers))
        self.enc_final_norm = ParamTree(tree["enc_final_norm"])
        self.dec_blocks = nn.ModuleList(
            ParamTree(tree["dec_blocks"][str(i)])
            for i in range(cfg.num_layers))
        self.final_norm = ParamTree(tree["final_norm"])


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> EncDec:
    """Random weights drawn on ``device`` by the reference's
    initializers (``transformer.init_leaf``)."""
    dt = DTYPES[cfg.dtype]
    return EncDec(cfg, {
        name: init_leaf(cfg, name, shape, dt, generator=generator,
                        device=device)
        for name, shape in param_shapes(cfg).items()})


def params_from_state(cfg: ModelConfig, state: dict, *, device) -> EncDec:
    """An :class:`EncDec` from a full state dict, each leaf cast to the
    config's dtype on ``device``."""
    check_state(cfg, state, param_shapes(cfg))
    dt = DTYPES[cfg.dtype]
    return EncDec(cfg, {k: v.to(device=device, dtype=dt)
                        for k, v in state.items()})


def _ln(p, x: torch.Tensor, lay=None) -> torch.Tensor:
    w = (lambda t: t) if lay is None else lay.local_weight
    return layers.layernorm(w(p["scale"]), w(p["bias"]), x)


def _layout(ctx):
    """The stream replicated over ``model`` (see the module docstring)."""
    return None if ctx is None else parallel.Layout(ctx)


def _with_positions(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    return x + sinusoidal(positions, x.shape[-1]).to(x.dtype)


def encode(params: EncDec, frames: torch.Tensor, *,
           plain: bool = False, lay=None) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> the encoder's output.
    Each layer is recomputed in the backward pass, as the reference's."""
    cfg = params.cfg
    spec = _spec(cfg, causal=False)
    x = _with_positions(frames, torch.arange(frames.shape[1],
                                             device=frames.device))
    for p in params.enc_blocks:
        x = layers.remat(_enc_block, spec, p, x, plain=plain, lay=lay)
    return _ln(params.enc_final_norm, x, lay)


def _enc_block(spec: attention.AttnSpec, p, x, *, plain: bool = False,
               lay=None):
    x = x + attention.apply_attention(p.attn, _ln(p.norm1, x, lay),
                                      spec=spec, plain=plain, lay=lay)
    return x + layers.mlp_apply(p.mlp, _ln(p.norm2, x, lay), "gelu", lay)


def _dec_block(cfg: ModelConfig, p, x, enc_out=None, *, self_cache=None,
               cross_cache=None, decode: bool = False, plain: bool = False,
               lay=None):
    spec_self = _spec(cfg, causal=True)
    spec_cross = _spec(cfg, causal=False)
    h = _ln(p.norm1, x, lay)
    if self_cache is None:
        a = attention.apply_attention(p.self_attn, h, spec=spec_self,
                                      plain=plain, lay=lay)
    elif decode:
        a, self_cache = attention.decode_attention(
            p.self_attn, h, self_cache, spec=spec_self, lay=lay)
    else:
        a, self_cache = attention.prefill_attention(
            p.self_attn, h, self_cache, spec=spec_self, plain=plain, lay=lay)
    x = x + a
    h = _ln(p.norm2, x, lay)
    if decode:
        c, _ = attention.decode_attention(p.cross_attn, h, self_cache,
                                          spec=spec_cross,
                                          kv_src_cache=cross_cache, lay=lay)
    else:
        c = attention.apply_attention(p.cross_attn, h, kv_src=enc_out,
                                      spec=spec_cross, plain=plain, lay=lay)
    x = x + c
    x = x + layers.mlp_apply(p.mlp, _ln(p.norm3, x, lay), "gelu", lay)
    return x, self_cache


def _embed(params: EncDec, tokens: torch.Tensor, positions: torch.Tensor,
           lay=None) -> torch.Tensor:
    return _with_positions(layers.embed_apply(params.embed["embedding"],
                                              tokens, lay=lay), positions)


def decoder_hidden(params: EncDec, enc_out: torch.Tensor,
                   tokens: torch.Tensor, *, plain: bool = False, lay=None
                   ) -> torch.Tensor:
    """The decoder over a whole sequence (teacher forcing): the hidden
    states before the final norm, (B, S, D); each layer is recomputed in
    the backward pass, as the reference's."""
    x = _embed(params, tokens, torch.arange(tokens.shape[1],
                                            device=tokens.device), lay)
    for p in params.dec_blocks:
        x, _ = layers.remat(_dec_block, params.cfg, p, x, enc_out,
                            plain=plain, lay=lay)
    return x


def logits_from_hidden(params: EncDec, x: torch.Tensor,
                       lay=None) -> torch.Tensor:
    """float32 logits over the padded vocabulary (unmasked, as the
    reference's); with ``lay`` whole on every rank."""
    h = _ln(params.final_norm, x, lay)
    if lay is None:
        return layers.unembed(params.embed["embedding"], h)
    w, _, split = transformer._head_local(params, lay)
    logits = layers.matmul_f32(h, w)
    return parallel.all_gather(logits, lay.tp_group, -1) if split \
        else logits


def loss_fn(params: EncDec, batch: dict, *, plain: bool = False,
            ctx=None):
    """batch: frames (B, S_enc, D), inputs/targets/mask (B, S_dec).
    Returns (ce, {"ce", "aux"}), aux 0; with ``ctx`` as
    ``transformer.loss_fn`` returns them on a mesh."""
    cfg = params.cfg
    lay = _layout(ctx)
    enc_out = encode(params, batch["frames"], plain=plain, lay=lay)
    x = decoder_hidden(params, enc_out, batch["inputs"], plain=plain,
                       lay=lay)
    h = _ln(params.final_norm, x, lay)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if lay is not None:
        return transformer.mesh_loss(params, h, batch, aux, lay)
    ce = layers.chunked_softmax_xent(
        h, params.embed["embedding"].T, batch["targets"], batch["mask"],
        valid_vocab=cfg.vocab_size)
    return ce, {"ce": ce, "aux": aux}


def make_cross_caches(params: EncDec, enc_out: torch.Tensor,
                      lay=None) -> list:
    """Each decoder layer's cross-attention K/V of the encoder's output;
    with ``lay`` of the rank's block of its positions
    (``attention.slot_block``)."""
    cfg = params.cfg
    b, s, _ = enc_out.shape
    start, n, group = attention.slot_block(lay, b, s,
                                           _spec(cfg, causal=False))
    rows = enc_out[:, start:start + n]
    w = (lambda t: t) if lay is None else (lambda t: lay.weight(t, None))
    caches = []
    for p in params.dec_blocks:
        k = layers.matmul(rows, w(p.cross_attn["wk"]))
        v = layers.matmul(rows, w(p.cross_attn["wv"]))
        if cfg.qkv_bias:
            k = k + w(p.cross_attn["bk"])
            v = v + w(p.cross_attn["bv"])
        caches.append(attention.KVCache(
            k.reshape(b, n, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, n, cfg.num_kv_heads, cfg.head_dim), s, start,
            group))
    return caches


def empty_caches(cfg: ModelConfig, batch: int, max_len: int, *, device,
                ctx=None, dtype=None) -> tuple:
    """Zero caches of ``prefill``'s layout, (self caches, cross caches of
    ``cfg.encoder_seq`` filled positions), with ``ctx`` the rank's blocks:
    the arguments of a decode step that no prefill made (a dry run's)."""
    lay = _layout(ctx)
    dt = dtype or DTYPES[cfg.dtype]
    self_caches = [attention.init_cache(batch, max_len, _spec(cfg,
                                                              causal=True),
                                        dtype=dt, device=device, lay=lay)
                   for _ in range(cfg.num_layers)]
    cross = []
    for _ in range(cfg.num_layers):
        cache = attention.init_cache(batch, cfg.encoder_seq,
                                     _spec(cfg, causal=False), dtype=dt,
                                     device=device, lay=lay)
        cache.length = cfg.encoder_seq
        cross.append(cache)
    return self_caches, cross


@torch.no_grad()
def prefill(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor, *,
            max_len: int, plain: bool = False, ctx=None):
    """Encode, then the prompt through the decoder.  Returns (last-token
    logits (B, 1, V), (self caches, cross caches))."""
    cfg = params.cfg
    lay = _layout(ctx)
    enc_out = encode(params, frames, plain=plain, lay=lay)
    cross = make_cross_caches(params, enc_out, lay)
    b, s = tokens.shape
    x = _embed(params, tokens, torch.arange(s, device=tokens.device), lay)
    spec = _spec(cfg, causal=True)
    self_caches = []
    for p in params.dec_blocks:
        cache = attention.init_cache(b, max_len, spec, dtype=DTYPES[cfg.dtype],
                                     device=tokens.device, lay=lay)
        x, cache = _dec_block(cfg, p, x, enc_out, self_cache=cache,
                              plain=plain, lay=lay)
        self_caches.append(cache)
    return logits_from_hidden(params, x[:, -1:, :], lay), (self_caches,
                                                          cross)


@torch.no_grad()
def decode_step(params: EncDec, token: torch.Tensor, caches, *, ctx=None):
    """token: (B, 1).  Returns (logits (B, 1, V), caches, the self caches
    updated in place)."""
    lay = _layout(ctx)
    self_caches, cross = caches
    pos = self_caches[0].length
    x = _embed(params, token, torch.full((1,), pos, device=token.device),
               lay)
    for i, p in enumerate(params.dec_blocks):
        x, self_caches[i] = _dec_block(params.cfg, p, x,
                                       self_cache=self_caches[i],
                                       cross_cache=cross[i], decode=True,
                                       lay=lay)
    return logits_from_hidden(params, x, lay), (self_caches, cross)

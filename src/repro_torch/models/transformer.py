"""Decoder-only LM assembly: blocks, layer loop, loss, prefill/decode.

Counterpart of ``repro.models.transformer``: the blocks of
``cfg.block_pattern``, cycled over layers, under either norm (rmsnorm or
layernorm, ``cfg.norm_type``):

  attn  — GQA attention + dense MLP
  lattn — local-window attention + MLP (a ring KV cache of the window)
  moe   — GQA attention + mixture-of-experts (and a shared expert when
          ``cfg.moe_shared_expert``)
  rwkv  — RWKV-6 TimeMix + ChannelMix (``models/rwkv6.py``)
  rec   — RG-LRU recurrent block + MLP (``models/rglru.py``)

A layer's cache is its KV cache (attention kinds) or its recurrent state
(``rwkv``: token-shift inputs and the WKV state; ``rec``: the conv inputs
and h).

Parameters are ``nn.Module`` trees that mirror the reference's parameter
tree name for name, so a state-dict key is the reference's path with the
layer index after ``blocks`` (``blocks.3.attn.wq``); the reference scans
a stacked copy of its blocks, the port loops over a ``ModuleList``.
Every tensor is created on the caller's device: weights are drawn there
from an explicit ``torch.Generator``.

``loss_fn``, ``prefill`` and ``decode_step`` take the reference's ``ctx``
(an ``LMContext``; None runs one device as before).  On a mesh the
parameters are DTensors placed by ``sharding.param_specs``
(``shard_params``), the batch is this rank's share of the data axes, and
each rank runs its part through ``distributed.parallel``: attention,
MLPs, experts, embedding and loss split over ``model``, the residual
stream split along the sequence at the layer boundary where
``cfg.seq_shard`` (the reference's ``bnd``; training and prefill, when
``model`` divides the sequence).  Every block kind runs on a mesh: the
recurrent ones (whose configs keep the stream replicated, ``seq_shard``
False) split RWKV-6's WKV along each head's key dim and the RG-LRU's
channels over ``model`` (``rwkv6.timemix_apply``,
``rglru.recurrent_block_apply``), and each rank's recurrent state is its
block of ``cache_specs``' split.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.models import attention, layers, moe as moe_lib
from repro_torch.models import rglru, rwkv6

BLOCK_KINDS = ("attn", "lattn", "moe", "rwkv", "rec")
NORM_TYPES = ("rmsnorm", "layernorm")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)


def attn_spec(cfg: ModelConfig, *, local: bool = False) -> attention.AttnSpec:
    return attention.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias, causal=True,
        window=cfg.local_window if local else None)


def moe_spec(cfg: ModelConfig) -> moe_lib.MoESpec:
    return moe_lib.MoESpec(
        d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        router_type=cfg.router_type)


def check_config(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    for kind in set(cfg.block_pattern):
        check_kind(kind)
    if cfg.norm_type not in NORM_TYPES:
        raise ValueError(cfg.norm_type)


def _norm_shapes(cfg: ModelConfig, prefix: str) -> dict:
    shapes = {f"{prefix}.scale": (cfg.d_model,)}
    if cfg.norm_type == "layernorm":
        shapes[f"{prefix}.bias"] = (cfg.d_model,)
    return shapes


def norm(cfg: ModelConfig, p, x: torch.Tensor, lay=None) -> torch.Tensor:
    """The config's norm: rmsnorm (``scale``) or layernorm (``scale``,
    ``bias``); with ``lay`` on the rank's residual stream."""
    w = (lambda t: t) if lay is None else lay.local_weight
    if cfg.norm_type == "layernorm":
        return layers.layernorm(w(p["scale"]), w(p["bias"]), x)
    return layers.rmsnorm(w(p["scale"]), x)


def prefixed(prefix: str, shapes: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in shapes.items()}


def block_shapes(cfg: ModelConfig, kind: str) -> dict:
    """Shapes of one block's parameters by dotted name."""
    check_kind(kind)
    d = cfg.d_model
    mlp = layers.mlp_shapes(d, cfg.d_ff, cfg.mlp_type)
    if kind == "rwkv":
        return {**_norm_shapes(cfg, "norm1"),
                **prefixed("tm", rwkv6.timemix_shapes(d)),
                **_norm_shapes(cfg, "norm2"),
                **prefixed("cm", rwkv6.channelmix_shapes(d, cfg.d_ff))}
    if kind == "rec":
        return {**_norm_shapes(cfg, "norm1"),
                **prefixed("rec", rglru.recurrent_shapes(
                    d, cfg.rnn_width, cfg.conv_width)),
                **_norm_shapes(cfg, "norm2"), **prefixed("mlp", mlp)}
    spec = attn_spec(cfg, local=kind == "lattn")
    shapes = _norm_shapes(cfg, "norm1")
    shapes.update(prefixed("attn", attention.attention_shapes(spec)))
    shapes.update(_norm_shapes(cfg, "norm2"))
    if kind == "moe":
        shapes.update(prefixed("moe", moe_lib.moe_shapes(moe_spec(cfg))))
        if cfg.moe_shared_expert:
            shapes.update(prefixed("shared", mlp))
    else:
        shapes.update(prefixed("mlp", mlp))
    return shapes


def leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A parameter's dtype: the config's, but float32 for MoE routers and
    the RG-LRU's ``lam`` in every config (the reference's ``init_moe`` and
    ``init_recurrent_block``)."""
    if name.endswith((".moe.router", ".rec.lam")):
        return torch.float32
    return DTYPES[cfg.dtype]


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape by state-dict name, in init order."""
    check_config(cfg)
    shapes = {"embed.embedding": (cfg.padded_vocab, cfg.d_model)}
    shapes.update(_norm_shapes(cfg, "final_norm"))
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.padded_vocab)
    for i in range(cfg.num_layers):
        shapes.update({f"blocks.{i}.{k}": v for k, v in
                       block_shapes(cfg, cfg.block_kind(i)).items()})
    return shapes


class ParamTree(nn.Module):
    """One dict of the reference's parameter tree: leaves become
    parameters, nested dicts child trees; ``p["name"]`` reads either."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


def unflatten(state: dict) -> dict:
    """A flat state dict as the nested tree of its dotted names."""
    tree: dict = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor
    return tree


class Block(ParamTree):
    """One layer: pre-norm attention (attn / lattn / moe), RWKV TimeMix
    (rwkv) or the RG-LRU block (rec), then a pre-norm MLP, mixture of
    experts or ChannelMix, each added to the residual stream."""

    def __init__(self, cfg: ModelConfig, kind: str, tree: dict):
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind
        self.spec = attn_spec(cfg, local=kind == "lattn")

    def forward(self, x, *, cache=None, decode: bool = False,
                plain: bool = False, lay=None):
        """Full sequence (cache None), prefill (cache given) or one-token
        decode.  Returns (x, aux, cache): ``aux`` is the router's
        load-balance loss of a moe block, None for the others.  With
        ``lay`` (a mesh) ``x`` is the rank's residual stream."""
        cfg = self.cfg
        if self.kind == "rwkv":
            return self._rwkv(x, cache, lay)
        if self.kind == "rec":
            return self._rec(x, cache, decode, lay)
        h = norm(cfg, self.norm1, x, lay)
        if cache is None:
            a = attention.apply_attention(self.attn, h, spec=self.spec,
                                          plain=plain, lay=lay)
        elif decode:
            a, cache = attention.decode_attention(self.attn, h, cache,
                                                  spec=self.spec, lay=lay)
        else:
            a, cache = attention.prefill_attention(self.attn, h, cache,
                                                   spec=self.spec,
                                                   plain=plain, lay=lay)
        x = x + a
        h = norm(cfg, self.norm2, x, lay)
        if self.kind != "moe":
            return x + layers.mlp_apply(self.mlp, h, cfg.mlp_type,
                                        lay), None, cache
        m, aux = moe_lib.moe_apply(self.moe, h, moe_spec(cfg), decode=decode,
                                   lay=lay)
        if cfg.moe_shared_expert:
            m = m + layers.mlp_apply(self.shared, h, cfg.mlp_type, lay)
        return x + m, aux, cache

    def _rwkv(self, x, state, lay):
        """TimeMix, then ChannelMix; a new state from ``state`` (zeros for
        a full sequence, as the reference starts one)."""
        cfg = self.cfg
        if state is None:
            state = rwkv6.init_rwkv_state(x.shape[0], cfg.d_model,
                                          dtype=x.dtype, device=x.device,
                                          lay=lay)
        h = norm(cfg, self.norm1, x, lay)
        tm_out, tm_x, wkv = rwkv6.timemix_apply(
            self.tm, h, state["tm_x"], state["wkv"], lay=lay,
            wkv_impl=cfg.wkv_impl)
        x = x + tm_out
        h = norm(cfg, self.norm2, x, lay)
        if lay is None:
            cm_out, cm_x = rwkv6.channelmix_apply(self.cm, h, state["cm_x"])
        else:
            cm_out, cm_x = rwkv6.channelmix_mesh(self.cm, h, state["cm_x"],
                                                 lay)
        return x + cm_out, None, {"tm_x": tm_x, "cm_x": cm_x, "wkv": wkv}

    def _rec(self, x, state, decode: bool, lay):
        cfg = self.cfg
        if state is None:
            state = rglru.init_recurrent_state(
                x.shape[0], cfg.rnn_width, cfg.conv_width, dtype=x.dtype,
                device=x.device, lay=lay)
        h = norm(cfg, self.norm1, x, lay)
        r, state = rglru.recurrent_block_apply(self.rec, h, state,
                                               decode=decode, lay=lay)
        x = x + r
        h = norm(cfg, self.norm2, x, lay)
        return x + layers.mlp_apply(self.mlp, h, cfg.mlp_type, lay), None, \
            state


class Transformer(nn.Module):
    """The decoder's parameters: ``embed``, ``final_norm``, ``lm_head``
    (untied configs) and ``blocks``."""

    def __init__(self, cfg: ModelConfig, state: dict):
        super().__init__()
        tree = unflatten(state)
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.register_parameter(
            "lm_head", nn.Parameter(tree["lm_head"]) if "lm_head" in tree
            else None)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.block_kind(i), tree["blocks"][str(i)])
            for i in range(cfg.num_layers))


def init_leaf(cfg: ModelConfig, name: str, shape, dtype, *,
              generator: torch.Generator, device) -> torch.Tensor:
    """One parameter drawn by the reference's initializer for its name:
    fan-in truncated normals for dense weights, the LoRA factors, the
    conv taps and MoE routers (the LoRA second factors at 1/sqrt(rank),
    the taps at 1/sqrt(width)), stddev d_model^-0.5 for the embedding,
    the RG-LRU's ``lam`` from U(0.9, 0.999), zeros for biases, norms,
    mixes, ``w0`` and ``u``.  As in the reference, the fan-in is a
    weight's first dim, which for the (E, d, f) expert stacks is the
    expert count."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "lam":
        return rglru.init_lam(shape[0], generator=generator, device=device)
    # Dense: the weights named w* but rwkv's w0 (a zero decay offset), and
    # these.
    if not (leaf in ("embedding", "lm_head", "router", "tm_w1", "tm_w2",
                     "conv_w") or (leaf.startswith("w") and leaf != "w0")):
        return torch.zeros(shape, dtype=dtype, device=device)
    scale = {"embedding": cfg.d_model ** -0.5,
             "conv_w": shape[0] ** -0.5, **rwkv6.INIT_SCALES}.get(leaf)
    return layers.dense_init(shape, generator=generator, device=device,
                             scale=scale, dtype=dtype)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> Transformer:
    """Random weights drawn on ``device`` (:func:`init_leaf`)."""
    return Transformer(cfg, {
        name: init_leaf(cfg, name, shape, leaf_dtype(cfg, name),
                        generator=generator, device=device)
        for name, shape in param_shapes(cfg).items()})


def check_state(cfg: ModelConfig, state: dict, want: dict) -> None:
    """Raise unless ``state`` has exactly the names and shapes of
    ``want``."""
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"state does not fit {cfg.name}: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}, wrong "
                         f"shapes {wrong[:5]}")


def params_from_state(cfg: ModelConfig, state: dict, *,
                      device) -> Transformer:
    """A :class:`Transformer` from a full state dict (names and shapes of
    :func:`param_shapes`), each leaf cast to :func:`leaf_dtype` on
    ``device`` (tensors already there in that dtype are shared)."""
    check_state(cfg, state, param_shapes(cfg))
    return Transformer(cfg, {k: v.to(device=device, dtype=leaf_dtype(cfg, k))
                             for k, v in state.items()})


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def layout(cfg: ModelConfig, ctx, seq_len: int, *, decode: bool = False):
    """The ``parallel.Layout`` of a pass over ``seq_len`` tokens on
    ``ctx`` (None without one): the residual stream split along the
    sequence where ``cfg.seq_shard`` and ``model`` divides it, the
    reference's ``bnd`` (never in decode; the recurrent configs, whose
    blocks read the whole sequence, set ``seq_shard`` False)."""
    if ctx is None:
        return None
    tp = ctx.axis_size(ctx.tp_axis)
    return parallel.Layout(ctx, cfg.seq_shard and not decode and tp > 1
                           and seq_len % tp == 0)


def backbone(params: Transformer, x: torch.Tensor, *, caches=None,
             decode: bool = False, plain: bool = False, lay=None):
    """Run all blocks.  Returns (x, aux_total, caches): the MoE routers'
    load-balance losses summed over layers (float32; 0 for dense
    stacks).  Under ``cfg.remat == "full"`` each block is recomputed in
    the backward pass (``layers.remat``; prefill and decode record no
    gradient, so they run the blocks once)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = params.cfg.remat == "full"
    for i, block in enumerate(params.blocks):
        kw = dict(cache=None if caches is None else caches[i],
                  decode=decode, plain=plain, lay=lay)
        x, aux, cache = layers.remat(block, x, **kw) if remat \
            else block(x, **kw)
        if aux is not None:
            aux_total = aux_total + aux
        if caches is not None:
            caches[i] = cache
    return x, aux_total, caches


def _head(params: Transformer):
    """The unembedding (D, V): the head, or the tied embedding's
    transpose."""
    return params.lm_head if params.lm_head is not None \
        else params.embed["embedding"]


def _head_local(params: Transformer, lay):
    """The rank's unembedding (D, V or V/tp), the first vocab id it holds
    and whether ``model`` splits the vocab."""
    w = _head(params)
    vdim = 1 if params.lm_head is not None else 0
    split = lay.model_dim(w) == vdim
    wl = lay.weight(w, vdim) if split else lay.local_weight(w)
    if params.lm_head is None:
        wl = wl.T
    return wl, (lay.tp_rank * wl.shape[1] if split else 0), split


def logits_from_hidden(params: Transformer, x: torch.Tensor,
                       lay=None) -> torch.Tensor:
    """float32 logits of ``x`` (B, s, D; whole on every rank with
    ``lay``), padded vocab rows masked."""
    cfg = params.cfg
    h = norm(cfg, params.final_norm, x, lay)
    if lay is None:
        logits = layers.unembed(params.embed["embedding"], h,
                                head=params.lm_head)
    else:
        w, _, split = _head_local(params, lay)
        logits = layers.matmul_f32(h, w)
        if split:
            logits = parallel.all_gather(logits, lay.tp_group, -1)
    # Mask padded vocab rows out of the softmax.
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    return logits


def embed_tokens(params: Transformer, tokens: torch.Tensor,
                 lay=None) -> torch.Tensor:
    return layers.embed_apply(
        params.embed["embedding"], tokens,
        scale_by_sqrt_dim=params.cfg.embed_scale_sqrt_dim, lay=lay)


def loss_fn(params: Transformer, batch: dict, *,
            plain: bool = False, ctx=None):
    """batch: dict(inputs (B,S) int, targets (B,S) int, mask (B,S)).
    Returns (ce + aux, {"ce", "aux"}).

    With ``ctx`` the batch is this rank's share of the data axes and the
    loss returned is the rank's share of the sum over them (what its
    backward pass starts from); the metrics are the whole batch's."""
    cfg = params.cfg
    lay = layout(cfg, ctx, batch["inputs"].shape[1])
    x = embed_tokens(params, batch["inputs"], lay)
    x, aux, _ = backbone(params, x, plain=plain, lay=lay)
    h = norm(cfg, params.final_norm, x, lay)
    if lay is None:
        w = params.lm_head
        if w is None:
            w = params.embed["embedding"].T
        ce = layers.chunked_softmax_xent(h, w, batch["targets"],
                                         batch["mask"],
                                         valid_vocab=cfg.vocab_size)
        return ce + aux, {"ce": ce, "aux": aux}
    return mesh_loss(params, h, batch, aux, lay)


def mesh_loss(params, h: torch.Tensor, batch: dict, aux: torch.Tensor,
              lay):
    """The loss on a mesh from the final-normed stream ``h``: the
    cross-entropy over the rank's vocab slice where ``model`` splits the
    vocab, ``aux`` (the routers' loss) added at its share of the data
    axes.  Returns the rank's share of the sum over the data axes and
    the whole batch's metrics."""
    cfg = params.cfg
    w, lo, split = _head_local(params, lay)
    targets, mask = batch["targets"], batch["mask"]
    count = lay.dp_sum(torch.sum(mask.float()))
    if split:
        ce = layers.chunked_softmax_xent(
            lay.to_full(h), w, targets, mask, valid_vocab=cfg.vocab_size,
            vocab_lo=lo, group=lay.tp_group, count=count)
    else:
        if lay.seq:
            targets, mask = (parallel.chunk(t, lay.tp_group, 1)
                             for t in (targets, mask))
        ce = layers.chunked_softmax_xent(h, w, targets, mask,
                                         valid_vocab=cfg.vocab_size,
                                         count=count)
        if lay.seq:
            ce = parallel.reduce_from(ce, lay.tp_group)
    dp = lay.ctx.dp_size
    loss = ce + aux / dp
    ce_all = lay.dp_sum(ce.detach())
    aux_all = lay.dp_sum(aux.detach()) / dp
    return loss, {"ce": ce_all, "aux": aux_all, "loss": ce_all + aux_all}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, device, lay=None):
    dt = DTYPES[cfg.dtype]
    if kind == "rwkv":
        return rwkv6.init_rwkv_state(batch, cfg.d_model, dtype=dt,
                                     device=device, lay=lay)
    if kind == "rec":
        return rglru.init_recurrent_state(batch, cfg.rnn_width,
                                          cfg.conv_width, dtype=dt,
                                          device=device, lay=lay)
    return attention.init_cache(batch, max_len,
                                attn_spec(cfg, local=kind == "lattn"),
                                dtype=dt, device=device, lay=lay)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device, ctx=None) -> list:
    """One cache a layer: a KV cache or a recurrent state (with ``ctx``,
    the rank's block of each leaf by ``cache_specs``; ``batch`` is the
    rank's)."""
    lay = layout(cfg, ctx, 1, decode=True)
    return [init_block_cache(cfg, cfg.block_kind(i), batch, max_len,
                             device=device, lay=lay)
            for i in range(cfg.num_layers)]


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, *, max_len: int,
            plain: bool = False, ctx=None):
    """Prompt pass; returns (last-token logits (B, 1, V), caches).  With
    ``ctx``, ``tokens`` are the rank's share of the batch."""
    cfg = params.cfg
    caches = init_caches(cfg, tokens.shape[0], max_len,
                         device=tokens.device, ctx=ctx)
    lay = layout(cfg, ctx, tokens.shape[1])
    x = embed_tokens(params, tokens, lay)
    x, _, caches = backbone(params, x, caches=caches, plain=plain, lay=lay)
    last = x[:, -1:, :]
    if lay is not None and lay.seq:
        last = parallel.all_gather(last, lay.tp_group, 1)[:, -1:]
    return logits_from_hidden(params, last, lay), caches


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor, caches: list, *,
                ctx=None):
    """token: (B, 1) int. Returns (logits (B, 1, V), caches updated in
    place)."""
    lay = layout(params.cfg, ctx, 1, decode=True)
    x = embed_tokens(params, token, lay)
    x, _, caches = backbone(params, x, caches=caches, decode=True, lay=lay)
    return logits_from_hidden(params, x, lay), caches


def shard_params(params: Transformer, ctx) -> Transformer:
    """``params`` (whole on every rank) with each parameter replaced by a
    DTensor on ``ctx.mesh`` placed by ``sharding.param_specs``; each rank
    keeps its block.  Returns the same module."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding
    whole = {k: p.detach() for k, p in params.named_parameters()
             if not isinstance(p, DTensor)}
    placed = sharding.to_named(
        whole, sharding.param_specs(whole, ctx, params.cfg), ctx)
    for name, t in placed.items():
        *path, leaf = name.split(".")
        owner = params.get_submodule(".".join(path)) if path else params
        setattr(owner, leaf, nn.Parameter(t))
    return params

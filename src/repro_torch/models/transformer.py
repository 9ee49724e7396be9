"""Decoder-only LM assembly: blocks, layer loop, loss, prefill/decode.

Counterpart of ``repro.models.transformer`` for the attention blocks
(cfg.block_pattern, cycled over layers), under either norm (rmsnorm or
layernorm, ``cfg.norm_type``):

  attn  — GQA attention + dense MLP
  lattn — local-window attention + MLP
  moe   — GQA attention + mixture-of-experts (and a shared expert when
          ``cfg.moe_shared_expert``)

``rwkv`` and ``rec`` blocks are still to be ported (ROADMAP.md queue 1)
and raise ``NotImplementedError``.

Parameters are ``nn.Module`` trees that mirror the reference's parameter
tree name for name, so a state-dict key is the reference's path with the
layer index after ``blocks`` (``blocks.3.attn.wq``); the reference scans
a stacked copy of its blocks, the port loops over a ``ModuleList``.
Every tensor is created on the caller's device: weights are drawn there
from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe as moe_lib

BLOCK_KINDS = ("attn", "lattn", "moe")
_UNPORTED_KINDS = ("rwkv", "rec")
NORM_TYPES = ("rmsnorm", "layernorm")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_kind(kind: str) -> None:
    if kind in _UNPORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md queue 1: "
            f"the rwkv6 and rglru blocks)")
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


def norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The config's norm: rmsnorm (``scale``) or layernorm (``scale``,
    ``bias``)."""
    if cfg.norm_type == "layernorm":
        return layers.layernorm(p["scale"], p["bias"], x)
    return layers.rmsnorm(p["scale"], x)


def block_shapes(cfg: ModelConfig, kind: str) -> dict:
    """Shapes of one block's parameters by dotted name."""
    check_kind(kind)
    spec = attn_spec(cfg, local=kind == "lattn")
    shapes = _norm_shapes(cfg, "norm1")
    shapes.update({f"attn.{k}": v
                   for k, v in attention.attention_shapes(spec).items()})
    shapes.update(_norm_shapes(cfg, "norm2"))
    mlp = layers.mlp_shapes(cfg.d_model, cfg.d_ff, cfg.mlp_type)
    if kind == "moe":
        shapes.update({f"moe.{k}": v for k, v in
                       moe_lib.moe_shapes(moe_spec(cfg)).items()})
        if cfg.moe_shared_expert:
            shapes.update({f"shared.{k}": v for k, v in mlp.items()})
    else:
        shapes.update({f"mlp.{k}": v for k, v in mlp.items()})
    return shapes


def leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A parameter's dtype: the config's, but float32 for MoE routers in
    every config (the reference's ``init_moe``)."""
    if name.endswith(".moe.router"):
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


def _unflatten(state: dict) -> dict:
    tree: dict = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor
    return tree


class Block(ParamTree):
    """One attn / lattn / moe layer: pre-norm attention, then a pre-norm
    MLP (or mixture of experts), each added to the residual stream."""

    def __init__(self, cfg: ModelConfig, kind: str, tree: dict):
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind
        self.spec = attn_spec(cfg, local=kind == "lattn")

    def forward(self, x, *, cache=None, decode: bool = False,
                plain: bool = False):
        """Full sequence (cache None), prefill (cache given) or one-token
        decode.  Returns (x, aux, cache): ``aux`` is the router's
        load-balance loss of a moe block, None for the others."""
        cfg = self.cfg
        h = norm(cfg, self.norm1, x)
        if cache is None:
            a = attention.apply_attention(self.attn, h, spec=self.spec,
                                          plain=plain)
        elif decode:
            a, cache = attention.decode_attention(self.attn, h, cache,
                                                  spec=self.spec)
        else:
            a, cache = attention.prefill_attention(self.attn, h, cache,
                                                   spec=self.spec,
                                                   plain=plain)
        x = x + a
        h = norm(cfg, self.norm2, x)
        if self.kind != "moe":
            return x + layers.mlp_apply(self.mlp, h, cfg.mlp_type), None, cache
        m, aux = moe_lib.moe_apply(self.moe, h, moe_spec(cfg), decode=decode)
        if cfg.moe_shared_expert:
            m = m + layers.mlp_apply(self.shared, h, cfg.mlp_type)
        return x + m, aux, cache


class Transformer(nn.Module):
    """The decoder's parameters: ``embed``, ``final_norm``, ``lm_head``
    (untied configs) and ``blocks``."""

    def __init__(self, cfg: ModelConfig, state: dict):
        super().__init__()
        tree = _unflatten(state)
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.register_parameter(
            "lm_head", nn.Parameter(tree["lm_head"]) if "lm_head" in tree
            else None)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.block_kind(i), tree["blocks"][str(i)])
            for i in range(cfg.num_layers))


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device) -> Transformer:
    """Random weights drawn on ``device``: fan-in truncated normals for
    dense weights and MoE routers (float32), stddev d_model^-0.5 for the
    embedding, zeros for biases and norm scales (the reference's
    initializers).  As in the reference, the fan-in is a weight's first
    dim, which for the (E, d, f) expert stacks is the expert count."""
    state = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        dt = leaf_dtype(cfg, name)
        if leaf == "embedding":
            state[name] = layers.dense_init(
                shape, generator=generator, device=device,
                scale=cfg.d_model ** -0.5, dtype=dt)
        elif leaf.startswith("w") or leaf in ("lm_head", "router"):
            state[name] = layers.dense_init(shape, generator=generator,
                                            device=device, dtype=dt)
        else:
            state[name] = torch.zeros(shape, dtype=dt, device=device)
    return Transformer(cfg, state)


def params_from_state(cfg: ModelConfig, state: dict, *,
                      device) -> Transformer:
    """A :class:`Transformer` from a full state dict (names and shapes of
    :func:`param_shapes`), each leaf cast to :func:`leaf_dtype` on
    ``device`` (tensors already there in that dtype are shared)."""
    want = param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise ValueError(f"state does not fit {cfg.name}: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}, wrong "
                         f"shapes {wrong[:5]}")
    return Transformer(cfg, {k: v.to(device=device, dtype=leaf_dtype(cfg, k))
                             for k, v in state.items()})


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def backbone(params: Transformer, x: torch.Tensor, *, caches=None,
             decode: bool = False, plain: bool = False):
    """Run all blocks.  Returns (x, aux_total, caches): the MoE routers'
    load-balance losses summed over layers (float32; 0 for dense
    stacks)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, block in enumerate(params.blocks):
        x, aux, cache = block(x, cache=None if caches is None else caches[i],
                              decode=decode, plain=plain)
        if aux is not None:
            aux_total = aux_total + aux
        if caches is not None:
            caches[i] = cache
    return x, aux_total, caches


def logits_from_hidden(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    cfg = params.cfg
    h = norm(cfg, params.final_norm, x)
    logits = layers.unembed(params.embed["embedding"], h,
                            head=params.lm_head)           # float32
    # Mask padded vocab rows out of the softmax.
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    return logits


def embed_tokens(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embed_apply(
        params.embed["embedding"], tokens,
        scale_by_sqrt_dim=params.cfg.embed_scale_sqrt_dim)


def loss_fn(params: Transformer, batch: dict, *,
            plain: bool = False):
    """batch: dict(inputs (B,S) int, targets (B,S) int, mask (B,S)).
    Returns (ce + aux, {"ce", "aux"})."""
    cfg = params.cfg
    x = embed_tokens(params, batch["inputs"])
    x, aux, _ = backbone(params, x, plain=plain)
    h = norm(cfg, params.final_norm, x)
    w = params.lm_head
    if w is None:
        w = params.embed["embedding"].T
    ce = layers.chunked_softmax_xent(h, w, batch["targets"], batch["mask"],
                                     valid_vocab=cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device) -> list:
    dt = DTYPES[cfg.dtype]
    return [attention.init_cache(
        batch, max_len, attn_spec(cfg, local=cfg.block_kind(i) == "lattn"),
        dtype=dt, device=device) for i in range(cfg.num_layers)]


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, *, max_len: int,
            plain: bool = False):
    """Prompt pass; returns (last-token logits (B, 1, V), caches)."""
    caches = init_caches(params.cfg, tokens.shape[0], max_len,
                         device=tokens.device)
    x = embed_tokens(params, tokens)
    x, _, caches = backbone(params, x, caches=caches, plain=plain)
    return logits_from_hidden(params, x[:, -1:, :]), caches


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor, caches: list):
    """token: (B, 1) int. Returns (logits (B, 1, V), caches updated in
    place)."""
    x = embed_tokens(params, token)
    x, _, caches = backbone(params, x, caches=caches, decode=True)
    return logits_from_hidden(params, x), caches

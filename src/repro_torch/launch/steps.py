"""Train / prefill / decode steps shared by the training driver and the
serving driver.

Counterpart of ``repro.launch.steps`` on one device: a step is an eager
function over the model's parameter tree (no jit, no shardings).
``train_step(params, opt_state, batch)`` runs ``loss_fn``, ``backward``
and ``AdamW.update``, which writes the parameters in place (the
reference donates them), clears the gradients and returns ``(params,
opt_state, metrics)``: ``loss``, ``ce``, ``aux``, ``grad_norm`` and
``lr``, all 0-d tensors on the device, so a step reads nothing back.
``StepBundle.args`` holds meta-device tensors of the step's arguments
(the reference's ``ShapeDtypeStruct``s).

The model runs on the CUDA device unless ``device`` says otherwise;
``plain=True`` runs the plain attention version (the on-card
comparison's reference run).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import attention, encdec, transformer
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState


@dataclasses.dataclass
class StepBundle:
    """A step function with meta tensors of its arguments."""
    fn: Any
    args: tuple
    description: str


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_specs(cfg: ModelConfig) -> dict:
    """Meta tensors of every parameter, by state-dict name."""
    if cfg.is_encdec:
        dt = transformer.DTYPES[cfg.dtype]
        return {k: _meta(s, dt) for k, s in encdec.param_shapes(cfg).items()}
    return {k: _meta(s, transformer.leaf_dtype(cfg, k))
            for k, s in transformer.param_shapes(cfg).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors of a step's inputs, as the reference's
    ``Model.input_specs``."""
    b, s = shape.global_batch, shape.seq_len
    dt = transformer.DTYPES[cfg.dtype]
    frames = {"frames": _meta((b, cfg.encoder_seq, cfg.d_model), dt)} \
        if cfg.is_encdec else {}
    if shape.kind == "train":
        return {"inputs": _meta((b, s), torch.int32),
                "targets": _meta((b, s), torch.int32),
                "mask": _meta((b, s), torch.float32), **frames}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s), torch.int32), **frames}
    if shape.kind == "decode":
        if cfg.is_encdec:
            spec = encdec._spec(cfg, causal=True)
            self_caches = [attention.init_cache(b, s, spec, dtype=dt,
                                                device="meta")
                           for _ in range(cfg.num_layers)]
            kv = (b, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
            cross = [attention.KVCache(_meta(kv, dt), _meta(kv, dt),
                                       cfg.encoder_seq)
                     for _ in range(cfg.num_layers)]
            caches = (self_caches, cross)
        else:
            caches = transformer.init_caches(cfg, b, s, device="meta")
        return {"token": _meta((b, 1), torch.int32), "caches": caches}
    raise ValueError(shape.kind)


def train_bundle(cfg: ModelConfig, shape: ShapeConfig,
                 opt: AdamW | None = None, *, device=None,
                 plain: bool = False) -> StepBundle:
    model = Model(cfg, device=device, plain=plain)
    opt = opt or AdamW()

    def train_step(params, opt_state: OptState, batch: dict):
        loss, metrics = model.loss_fn(params, batch)
        loss.backward()
        leaves = dict(params.named_parameters())
        opt_state, opt_metrics = opt.update(
            params, {k: p.grad for k, p in leaves.items()}, opt_state)
        for p in leaves.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in
                   dict(metrics, loss=loss, **opt_metrics).items()}
        return params, opt_state, metrics

    params = param_specs(cfg)
    moments = {k: _meta(p.shape, torch.float32) for k, p in params.items()}
    opt_state = OptState(moments, dict(moments), _meta((), torch.int32))
    return StepBundle(train_step, (params, opt_state,
                                   input_specs(cfg, shape)),
                      f"train_step {cfg.name} {shape.name}")


def prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, *, device=None,
                   plain: bool = False) -> StepBundle:
    model = Model(cfg, device=device, plain=plain)

    def prefill_step(params, batch: dict):
        logits, caches = model.prefill(params, batch, max_len=shape.seq_len)
        return torch.argmax(logits, -1).to(torch.int32), caches

    return StepBundle(prefill_step, (param_specs(cfg),
                                     input_specs(cfg, shape)),
                      f"prefill {cfg.name} {shape.name}")


def decode_bundle(cfg: ModelConfig, shape: ShapeConfig, *, device=None,
                  plain: bool = False) -> StepBundle:
    """serve_step: one new token against a ``seq_len`` cache, updated in
    place."""
    model = Model(cfg, device=device, plain=plain)
    specs = input_specs(cfg, shape)

    def serve_step(params, token, caches):
        logits, caches = model.decode_step(params, token, caches)
        return torch.argmax(logits, -1).to(torch.int32), caches

    return StepBundle(serve_step, (param_specs(cfg), specs["token"],
                                   specs["caches"]),
                      f"serve_step {cfg.name} {shape.name}")


def bundle_for(cfg: ModelConfig, shape: ShapeConfig, *, device=None,
               plain: bool = False) -> StepBundle:
    builders = {"train": train_bundle, "prefill": prefill_bundle,
                "decode": decode_bundle}
    if shape.kind not in builders:
        raise ValueError(shape.kind)
    return builders[shape.kind](cfg, shape, device=device, plain=plain)

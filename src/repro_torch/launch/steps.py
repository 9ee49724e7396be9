"""Train / prefill / decode steps shared by the training driver and the
serving driver.

Counterpart of ``repro.launch.steps``: a step is an eager function over
the model's parameter tree (no jit).
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

With ``ctx`` (an ``LMContext``) a step runs on its mesh, as the
reference's sharded jit does: the parameters are DTensors placed by
``sharding.param_specs`` (``Model.shard``), the moments by
``opt_state_specs`` (``AdamW.init(params, ctx)``), and the step takes the
whole batch on every rank and keeps the rank's share by
``batch_specs``; the tokens it returns are gathered over the data axes,
the caches stay the rank's (``cache_specs``).  ``StepBundle.specs`` holds
the spec trees, the reference's in_shardings.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import parallel, sharding
from repro_torch.models import encdec, transformer
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, OptState


@dataclasses.dataclass
class StepBundle:
    """A step function with meta tensors of its arguments."""
    fn: Any
    args: tuple
    description: str
    specs: tuple = ()


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
            caches = encdec.empty_caches(cfg, b, s, device="meta")
        else:
            caches = transformer.init_caches(cfg, b, s, device="meta")
        return {"token": _meta((b, 1), torch.int32), "caches": caches}
    raise ValueError(shape.kind)


def local_batch(batch: dict, ctx, *, must_split: bool = False) -> dict:
    """This rank's share of ``batch`` (the same whole batch on every rank)
    by ``batch_specs``; ``must_split`` raises where the data axes cannot
    split it (a training step would count such a batch once per rank)."""
    if ctx is None:
        return batch
    specs = sharding.batch_specs(batch, ctx, ctx.dp_axes)
    out = {}
    for k, v in batch.items():
        if specs[k] and specs[k][0] is not None:
            out[k] = v.chunk(ctx.dp_size, 0)[ctx.dp_rank()]
        elif must_split and ctx.dp_size > 1 and v.dim():
            raise ValueError(f"a batch of {v.shape[0]} does not split over "
                             f"{ctx.dp_size} data-parallel ranks")
        else:
            out[k] = v
    return out


def gather_batch(x: torch.Tensor, ctx) -> torch.Tensor:
    """The ranks' rows of ``x`` over the data axes, first axis major (the
    inverse of :func:`local_batch` for a split batch)."""
    if ctx is None:
        return x
    for a in reversed(ctx.dp_axes):
        if ctx.axis_size(a) > 1:
            x = parallel.all_gather(x, ctx.group(a), 0)
    return x


def _device(device, ctx):
    return ctx.device if ctx is not None else device


def train_bundle(cfg: ModelConfig, shape: ShapeConfig,
                 opt: AdamW | None = None, *, device=None,
                 plain: bool = False, ctx=None) -> StepBundle:
    model = Model(cfg, device=_device(device, ctx), plain=plain)
    opt = opt or AdamW()

    def train_step(params, opt_state: OptState, batch: dict):
        loss, metrics = model.loss_fn(
            params, local_batch(batch, ctx, must_split=True), ctx)
        loss.backward()
        leaves = dict(params.named_parameters())
        opt_state, opt_metrics = opt.update(
            params, {k: p.grad for k, p in leaves.items()}, opt_state)
        for p in leaves.values():
            p.grad = None
        metrics = dict(metrics, **opt_metrics)
        metrics.setdefault("loss", loss)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, metrics

    params = param_specs(cfg)
    moments = {k: _meta(p.shape, torch.float32) for k, p in params.items()}
    opt_state = OptState(moments, dict(moments), _meta((), torch.int32))
    batch = input_specs(cfg, shape)
    specs = ()
    if ctx is not None:
        pspec = sharding.param_specs(params, ctx, cfg)
        specs = (pspec, sharding.opt_state_specs(pspec, params, ctx,
                                                 cfg=cfg),
                 sharding.batch_specs(batch, ctx, ctx.dp_axes))
    return StepBundle(train_step, (params, opt_state, batch),
                      f"train_step {cfg.name} {shape.name}", specs)


def prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, *, device=None,
                   plain: bool = False, ctx=None) -> StepBundle:
    model = Model(cfg, device=_device(device, ctx), plain=plain)

    def prefill_step(params, batch: dict):
        local = local_batch(batch, ctx)
        logits, caches = model.prefill(params, local, max_len=shape.seq_len,
                                       ctx=ctx)
        tok = torch.argmax(logits, -1).to(torch.int32)
        if local["tokens"].shape[0] != batch["tokens"].shape[0]:
            tok = gather_batch(tok, ctx)
        return tok, caches

    params, batch = param_specs(cfg), input_specs(cfg, shape)
    specs = () if ctx is None else (
        sharding.param_specs(params, ctx, cfg),
        sharding.batch_specs(batch, ctx, ctx.dp_axes))
    return StepBundle(prefill_step, (params, batch),
                      f"prefill {cfg.name} {shape.name}", specs)


def decode_bundle(cfg: ModelConfig, shape: ShapeConfig, *, device=None,
                  plain: bool = False, ctx=None) -> StepBundle:
    """serve_step: one new token against a ``seq_len`` cache, updated in
    place (on a mesh: the rank's block of the cache)."""
    model = Model(cfg, device=_device(device, ctx), plain=plain)
    specs = input_specs(cfg, shape)

    def serve_step(params, token, caches):
        local = local_batch({"token": token}, ctx)["token"]
        logits, caches = model.decode_step(params, local, caches, ctx=ctx)
        tok = torch.argmax(logits, -1).to(torch.int32)
        if local.shape[0] != token.shape[0]:
            tok = gather_batch(tok, ctx)
        return tok, caches

    params = param_specs(cfg)
    shardings = () if ctx is None else (
        sharding.param_specs(params, ctx, cfg),
        sharding.batch_specs({"token": specs["token"]}, ctx, ctx.dp_axes),
        sharding.cache_specs(specs["caches"], ctx, tp=ctx.tp_axis,
                             dp_axes=ctx.dp_axes))
    return StepBundle(serve_step, (params, specs["token"], specs["caches"]),
                      f"serve_step {cfg.name} {shape.name}", shardings)


def bundle_for(cfg: ModelConfig, shape: ShapeConfig, *, device=None,
               plain: bool = False, ctx=None) -> StepBundle:
    builders = {"train": train_bundle, "prefill": prefill_bundle,
                "decode": decode_bundle}
    if shape.kind not in builders:
        raise ValueError(shape.kind)
    return builders[shape.kind](cfg, shape, device=device, plain=plain,
                                ctx=ctx)

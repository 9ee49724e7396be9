"""Rank programs of ``tests/test_torch_mesh.py``.

:func:`run` spawns ``world`` processes that join one ``gloo`` group
(``init_method=file://`` under the test's ``tmp_path``, so parallel test
workers cannot collide on ports) and each run one scenario of this
module on an LM mesh; rank 0 saves what the scenario returns, and
:func:`run` loads it.  The test process passes its inputs (the
reference's weights as port state dicts, batches) through ``in.pt``.
Nothing here imports JAX or the reference package: the ranks run the
port alone.
"""
from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist


def run(scenario: str, tmp_path: Path, inputs: dict, world: int = 4):
    import torch.multiprocessing as mp
    torch.save(inputs, tmp_path / "in.pt")
    mp.spawn(_entry, args=(world, str(tmp_path), scenario), nprocs=world,
             join=True)
    return torch.load(tmp_path / "out.pt", weights_only=False)


def _entry(rank: int, world: int, tmp: str, scenario: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.launch import mesh
    mesh.init_process_group("cpu", rank=rank, world_size=world,
                            init_method=f"file://{tmp}/store")
    try:
        out = globals()[scenario](torch.load(f"{tmp}/in.pt",
                                             weights_only=False), tmp)
        if rank == 0:
            torch.save(out, f"{tmp}/out.pt")
    finally:
        dist.destroy_process_group()


def _model(arch: str, overrides: dict, state: dict, ctx):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import Model
    model = Model(get_smoke_config(arch).replace(**overrides), device="cpu")
    return model, model.shard(model.load(state), ctx)


def _full(tree: dict) -> dict:
    return {k: v.full_tensor() for k, v in tree.items()}


def moe(inp: dict, tmp: str) -> dict:
    """dbrx on (2, 2): the loss at capacity factor 8 (no drops), then the
    MoE layer of block 0 on each rank's share of ``x`` by both paths at
    ``inp["drop_cf"]``."""
    from repro_torch.distributed.parallel import Layout
    from repro_torch.launch import mesh, steps
    from repro_torch.models import moe as moe_lib, transformer
    ctx = mesh.make_small_context(2, 2)
    model, params = _model("dbrx_132b", {"capacity_factor": 8.0},
                           inp["state"], ctx)
    _, m = model.loss_fn(params, steps.local_batch(inp["batch"], ctx), ctx)
    out = {"ce": m["ce"], "aux": m["aux"]}
    model, params = _model("dbrx_132b", {"capacity_factor": inp["drop_cf"]},
                           inp["state"], ctx)
    spec = transformer.moe_spec(params.cfg)
    x = steps.local_batch({"x": inp["x"]}, ctx)["x"]
    lay = Layout(ctx)
    for path, decode in (("a2a", False), ("psum", True)):
        y, aux = moe_lib.moe_apply(params.blocks[0].moe, x, spec,
                                   decode=decode, lay=lay)
        out[f"y_{path}"] = steps.gather_batch(y, ctx)
        out[f"aux_{path}"] = steps.gather_batch(aux[None], ctx)
    return out


def train_step(inp: dict, tmp: str) -> dict:
    """One phi3 ``train_bundle`` step on (2, 2): the metrics, and the
    parameters and moments gathered whole."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh, steps
    from repro_torch.optim.adamw import AdamW
    ctx = mesh.make_small_context(2, 2)
    model, params = _model("phi3_mini_3_8b", {}, inp["state"], ctx)
    opt = AdamW()
    bundle = steps.train_bundle(params.cfg, ShapeConfig("t", 64, 8, "train"),
                                opt, device="cpu", ctx=ctx)
    state = opt.init(params, ctx)
    params, state, metrics = bundle.fn(params, state, inp["batch"])
    full = _full(dict(params.named_parameters()))
    return {"metrics": metrics, "params": full, "mu": _full(state.mu),
            "nu": _full(state.nu), "count": state.count,
            "placements": {k: str(p.placements) for k, p in
                           params.named_parameters()}}


def attention(inp: dict, tmp: str) -> dict:
    """Per config: greedy ``serve`` tokens on (2, 2) with the caches
    split along the sequence, and the loss of a batch."""
    from repro_torch.launch import mesh, serve_lm, steps
    ctx = mesh.make_small_context(2, 2)
    out = {}
    for name, (overrides, state) in inp["configs"].items():
        model, params = _model("mistral_nemo_12b", overrides, state, ctx)
        gen, _ = serve_lm.serve("mistral_nemo_12b", params=params, ctx=ctx,
                                verbose=False, **inp["serve"])
        _, m = model.loss_fn(params, steps.local_batch(inp["batch"], ctx),
                             ctx)
        caches = model.init_caches(2, inp["serve"]["max_len"], ctx)
        out[name] = {"tokens": gen, "ce": m["ce"],
                     "cache_slots": caches[0].k.shape[1],
                     "cache_start": caches[0].start}
    # constrain: a guarded redistribute of a DTensor
    from repro_torch.distributed import sharding
    x = sharding.distribute(torch.arange(24.0).reshape(4, 6), (None, None),
                            ctx)
    y = sharding.constrain(x, ctx, ("data", "model"))
    z = sharding.constrain(x, ctx, (None, ("data", "model")))  # 6 % 4: drop
    out["constrain"] = (str(y.placements), str(z.placements),
                        bool(torch.equal(y.full_tensor(), x.full_tensor())))
    return out


def checkpoint(inp: dict, tmp: str) -> dict:
    """A qwen train state saved on (2, 2) after one step and restored onto
    (4, 1): every leaf equal, on its new placement."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh, steps
    from repro_torch.optim.adamw import AdamW
    opt = AdamW(lr=1e-2, warmup_steps=1)
    out = {}
    ctx = mesh.make_small_context(2, 2)
    model, params = _model("qwen1_5_0_5b", {}, inp["state"], ctx)
    state = opt.init(params, ctx)
    bundle = steps.train_bundle(params.cfg, ShapeConfig("t", 32, 4, "train"),
                                opt, device="cpu", ctx=ctx)
    params, state, _ = bundle.fn(params, state, inp["batch"])
    ckpt.save(f"{tmp}/ck", 1, (params, state))
    saved = (_full(dict(params.named_parameters())), _full(state.mu))
    # only rank 0 keeps a host copy (whole tensors); the async writer
    # runs there alone
    host = ckpt._to_host((params, state))
    writer = ckpt.AsyncCheckpointer()
    writer.save(f"{tmp}/async", 2, (params, state))
    kept = (None if host is None else
            {k: tuple(a.shape) for k, a, _ in host if "embedding" in k},
            writer._thread is not None)
    writer.join()
    out["kept"] = [None] * dist.get_world_size()
    dist.all_gather_object(out["kept"], kept)
    out["async_step"] = ckpt.latest_step(f"{tmp}/async")
    ctx2 = mesh.make_small_context(4, 1)
    model2, params2 = _model("qwen1_5_0_5b", {}, inp["other_state"], ctx2)
    state2 = opt.init(params2, ctx2)
    (params2, state2), _, step = ckpt.restore(f"{tmp}/ck", (params2, state2))
    got = (_full(dict(params2.named_parameters())), _full(state2.mu))
    out["equal"] = all(torch.equal(a[k], b[k]) for a, b in zip(saved, got)
                       for k in a)
    out["step"], out["count"] = step, int(state2.count)
    out["mesh"] = [tuple(p.device_mesh.mesh.shape)
                   for p in params2.parameters()][:1]
    key = "embed.embedding"
    out["local_shapes"] = (tuple(state.mu[key].to_local().shape),
                           tuple(state2.mu[key].to_local().shape))
    return out



def _cache_blocks(local, whole, spec, mesh) -> tuple[int, list]:
    """(leaves checked, mismatches): each leaf of the rank's cache tree
    ``local`` against the block of the whole tree's leaf that its spec
    (``spec``, the tree ``cache_specs`` gave for ``whole``) keeps."""
    from repro_torch.distributed.sharding import axes_size
    if hasattr(whole, "k") and hasattr(whole, "v"):
        local, whole = ({"k": t.k, "v": t.v} for t in (local, whole))
    if isinstance(whole, (dict, list, tuple)):
        keys = list(whole) if isinstance(whole, dict) else \
            range(len(whole))
        n, bad = 0, []
        for k in keys:
            dn, dbad = _cache_blocks(local[k], whole[k], spec[k], mesh)
            n, bad = n + dn, bad + dbad
        return n, bad
    want = tuple(d // (1 if p is None else axes_size(mesh, p))
                 for d, p in zip(whole.shape, spec))
    got = tuple(local.shape)
    return 1, [] if got == want else [(got, want)]


def family(inp: dict, tmp: str) -> dict:
    """One architecture on each mesh of ``inp["meshes"]`` ((data, model),
    config overrides, state): the loss and every gradient of a batch,
    greedy ``serve`` tokens, two greedy tokens of the prefill and decode
    bundles and their caches against the ``cache_specs`` blocks, then
    one ``train_bundle`` step's metrics."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh, serve_lm, steps
    from repro_torch.models import encdec, transformer
    from repro_torch.optim.adamw import AdamW
    arch, batch, kw = inp["arch"], inp["batch"], inp["serve"]
    out = {}
    for name, (shape, overrides, state) in inp["meshes"].items():
        ctx = mesh.make_small_context(*shape)
        model, params = _model(arch, overrides, state, ctx)
        cfg = params.cfg
        loss, metrics = model.loss_fn(params, steps.local_batch(batch, ctx),
                                      ctx)
        loss.backward()
        grads = {k: p.grad.full_tensor()
                 for k, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        tokens, _ = serve_lm.serve(arch, params=params, ctx=ctx,
                                   verbose=False, **kw)
        # the prefill and decode bundles: two greedy tokens, the caches
        b, cache_len = kw["batch"], kw["max_len"]
        prefill = steps.prefill_bundle(cfg, ShapeConfig(
            "p", cache_len, b, "prefill"), device="cpu", ctx=ctx)
        decode = steps.decode_bundle(cfg, ShapeConfig(
            "d", cache_len, b, "decode"), device="cpu", ctx=ctx)
        first, caches = prefill.fn(params, serve_lm.model_inputs(
            cfg, b, kw["prompt_len"], kw["seed"], "cpu"))
        second, caches = decode.fn(params, first, caches)
        if cfg.is_encdec:
            whole = encdec.empty_caches(cfg, kw["batch"], kw["max_len"],
                                        device="meta")
        else:
            whole = transformer.init_caches(cfg, kw["batch"], kw["max_len"],
                                            device="meta")
        blocks = _cache_blocks(caches, whole, sharding.cache_specs(
            whole, ctx, tp=ctx.tp_axis, dp_axes=ctx.dp_axes), ctx)
        opt = AdamW()
        bundle = steps.train_bundle(cfg, ShapeConfig(
            "t", batch["inputs"].shape[1], batch["inputs"].shape[0],
            "train"), opt, device="cpu", ctx=ctx)
        _, _, step = bundle.fn(params, opt.init(params, ctx), batch)
        out[name] = {"ce": metrics["ce"], "grads": grads, "tokens": tokens,
                     "bundle_tokens": torch.cat([first, second], 1),
                     "cache_blocks": blocks, "step": step}
    return out

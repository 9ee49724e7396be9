"""End-to-end training driver: the sharded train step, checkpoint/restart
and a metrics log.

Counterpart of ``repro.launch.train``, with its arguments and history keys
(``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``, ``step``,
``tokens_per_s``).  The step runs on an LM mesh as the reference's does:
``production_mesh`` (``--production-mesh``) takes ``mesh.make_context()``
(the process group's ranks, shrunk as the reference shrinks it), and a
running process group of several ranks (``torchrun``) gives the
reference's default, ``make_small_context(data=world, model=1)``.  A
caller may hand in its own ``ctx``.  With no process group and no
``production_mesh``, the step runs on one device without a mesh, the CUDA
device unless ``device`` says otherwise (``"cpu"`` runs the plain PyTorch
versions on the host; the production mesh there is one ``gloo`` rank).
``params`` hands in initial weights (a ``Model.init``/``Model.load`` tree
of the same config, trained in place, placed on the mesh if there is
one); by default they are drawn on the device from seed 0.

Fault tolerance: asynchronous checkpoints every ``ckpt_every`` steps (the
parameters and the optimizer state; the token stream is deterministic in
the step, so the step counter is the data pipeline's whole state) and one
at the end; a rerun with the same ``ckpt_dir`` resumes from the latest.
Metrics stay on the device except at log steps.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --production-mesh --steps 20
    python -m repro_torch.launch.train --arch qwen1_5_0_5b --full-config \\
        --seq-len 4096 --global-batch 4 --steps 6 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeConfig, get_config, get_smoke_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW


def train(arch: str, *, steps: int = 100, seq_len: int = 128,
          global_batch: int = 8, smoke: bool = True, lr: float = 3e-4,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = True, log_every: int = 10,
          overrides: dict | None = None, verbose: bool = True,
          device=None, params=None, production_mesh: bool = False,
          ctx=None):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.is_encdec:
        raise NotImplementedError("use whisper smoke via tests; train.py "
                                  "drives decoder-only archs")
    if params is not None and params.cfg != cfg:
        raise ValueError(f"params are of {params.cfg.name}, not of the "
                         f"config {cfg.name} with these overrides")
    if ctx is None and production_mesh:
        mesh_lib.init_process_group(device)
        ctx = mesh_lib.make_context()
    elif ctx is None and dist.is_initialized() and dist.get_world_size() > 1:
        ctx = mesh_lib.make_small_context(data=dist.get_world_size(),
                                          model=1)
    verbose = verbose and (ctx is None or dist.get_rank() == 0)
    shape = ShapeConfig("custom", seq_len, global_batch, "train")
    opt = AdamW(lr=lr, total_steps=steps,
                warmup_steps=max(10, steps // 20))
    bundle = steps_lib.train_bundle(cfg, shape, opt, device=device, ctx=ctx)
    model = Model(cfg, device=device if ctx is None else ctx.device)
    dev = model.device
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0))
    if ctx is not None:
        params = model.shard(params, ctx)
    opt_state = opt.init(params, ctx)

    stream = TokenStream(cfg.vocab_size, seq_len, global_batch)
    saver = ckpt.AsyncCheckpointer()
    start_step = 0
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        (params, opt_state), _, start_step = ckpt.restore(
            ckpt_dir, (params, opt_state))
        if verbose:
            print(f"resumed from step {start_step}", flush=True)

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        params, opt_state, metrics = bundle.fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["tokens_per_s"] = (global_batch * seq_len * (step + 1
                                 - start_step)) / (time.perf_counter() - t0)
            history.append(m)
            if verbose:
                print(json.dumps({k: round(v, 4) for k, v in m.items()}),
                      flush=True)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            saver.save(ckpt_dir, step + 1, (params, opt_state),
                       metadata={"arch": arch, "cfg": cfg.name})
    saver.join()
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, (params, opt_state),
                  metadata={"arch": arch, "done": True})
    return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if "WORLD_SIZE" in os.environ:           # started by torchrun
        mesh_lib.init_process_group(args.device,
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]),
                                    init_method="env://")
    train(args.arch, steps=args.steps, seq_len=args.seq_len,
          global_batch=args.global_batch, smoke=not args.full_config,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          resume=not args.no_resume, overrides=overrides or None,
          device=args.device, production_mesh=args.production_mesh)


if __name__ == "__main__":
    main()

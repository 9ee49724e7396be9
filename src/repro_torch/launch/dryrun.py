"""Dry-run of the (arch x shape x mesh) cells on a fake process group.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's jitted step for 256 or 512 forced host devices and reads
XLA's memory and cost analyses.  PyTorch compiles no whole program, so a
cell here runs the step itself, with nothing real behind it:

* a ``fake`` process group of 256 or 512 ranks in this one process
  (``FakeStore``; the collectives return at once), the production mesh
  over it (``mesh.make_context``) and this process as rank 0;
* the step of ``steps.bundle_for`` on fake tensors (``FakeTensorMode``:
  shapes, dtypes and devices, no storage) of the rank's shard of every
  parameter, moment, batch and cache, placed by the sharding rules.  The
  flash op's fake implementation stands for the kernel wherever the card
  runs it (head dims 64, 128, 256), so the forward keeps no score matrix;
  the backward recomputes attention through the plain version, as the
  card's does;
* under it, ``MemTracker`` (peak bytes per device by kind: parameters,
  gradients, optimizer state, activations and temporaries),
  ``FlopCounterMode`` (the rank's FLOPs), ``CommDebugMode`` (collective
  calls by type) and a dispatch mode that counts the bytes every op reads
  and writes and the bytes each collective moves.

``roofline_terms`` of those counts, ``model_flops``, ``params_total`` and
``params_active`` complete the record; ``over_card`` flags a cell whose
peak exceeds the card's 80 GB.  The PH cells run the port's
``sharded_plan`` for real over one rank's share of the batch (the
program reads values on the host, which fake tensors cannot), through
the kernels on the card, counting its live bytes and kernel launches,
beside ``ph_program_cost``: synthetic astro frames at the engine's
thresholds through the Boruvka-fused merge the card runs (the default
scan merge is sequential); the tiled cell is ``per_tile_cost``.

A cell runs on the card (the fake mesh on ``cuda``, the PH share through
the kernels) unless ``--device cpu`` asks for the host, where the mesh is
``cpu`` and the PH share takes the plain versions; without CUDA it raises
unless the host is asked for.

Every architecture's cells trace: the decoders of every block kind
(attention, mixture-of-experts, RWKV-6, RG-LRU) and the Whisper
encoder-decoder, whose decode cells take zero caches of the prefill's
layout (``encdec.empty_caches``).  A cell that fails records its error,
as the reference's sweep records a failed cell and goes on.

Usage (the CLI and the artifact layout of the reference's, under
``artifacts/dryrun_torch/``):
  python -m repro_torch.launch.dryrun --arch gemma_7b --shape train_4k
  python -m repro_torch.launch.dryrun --sweep [--multi-pod-too]
``REPRO_DRYRUN_DEVICES=N`` takes a smaller fake world (the mesh shrinks
as the reference's does), and ``--global-batch`` overrides the shape's
batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
CARD_BYTES = 80e9            # the H100's 80 GB of HBM3
COLLECTIVES = {                # c10d and functional ops -> collective type
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "barrier": "barrier"}


def world_size(multi_pod: bool) -> int:
    n = os.environ.get("REPRO_DRYRUN_DEVICES")
    return int(n) if n else (512 if multi_pod else 256)


def resolve_device(device: str | None) -> torch.device:
    """The cells' device: the card unless ``device`` names the host."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry run runs on the CUDA device by default and no CUDA "
            "device is available; pass --device cpu to run on the host")
    return dev


def fake_group(n: int) -> None:
    """A fake process group of ``n`` ranks; this process is rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is running; the cell wants {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def _flash_flops(q_shape, k_shape, v_shape, causal, window, q_offset, *,
                 out_shape=None, **kwargs) -> int:
    """The flash op's two products over the (q, k) pairs its mask leaves
    (``FlopCounterMode`` has no formula for a custom op)."""
    b, h, sq, hd = q_shape
    skv = k_shape[2]
    pairs = 0
    for i in range(q_offset, q_offset + sq):
        hi = min(i + 1, skv) if causal else skv
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return 4 * b * h * hd * pairs


def _register_flash_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    from repro_torch.kernels.flash_attention import ops  # noqa: F401
    op = torch.ops.repro_torch.flash_attention_fwd.default
    try:
        register_flop_formula(op, get_raw=True)(_flash_flops)
    except ValueError:       # registered by an earlier cell of this process
        pass


class _Traffic(TorchDispatchMode):
    """Bytes every op reads and writes (its tensor arguments and results,
    an in-place result counted as written; views move nothing and are not
    counted), and per collective type its calls and the bytes of its
    tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        moved = sum(t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
        kind = COLLECTIVES.get(func._schema.name.split("::")[-1])
        if kind is not None:
            sent = sum(t.numel() * t.element_size()
                       for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor))
            calls, nbytes = self.coll.get(kind, (0, 0))
            self.coll[kind] = (calls + 1, nbytes + sent)
        else:
            self.bytes += moved
        return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_path: Path,
             overrides: dict | None = None, *, global_batch=None,
             device: str | None = None) -> dict:
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import mesh

    t0 = time.time()
    dev = resolve_device(device)
    n = world_size(multi_pod)
    fake_group(n)
    ctx = mesh.make_context(multi_pod=multi_pod, device_type=dev.type)
    mesh_name = "x".join(str(s) for s in ctx.mesh.mesh.shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "devices": n}
    try:
        if arch == "pixhomology":
            if overrides:
                rec["overrides"] = overrides
            rec.update(_run_pixhomology(ctx, shape_name, overrides, dev))
        else:
            cfg = get_config(arch)
            if overrides:
                cfg = cfg.replace(**overrides)
                rec["overrides"] = overrides
            shape = SHAPES[shape_name]
            if global_batch:
                shape = dataclasses.replace(shape, global_batch=global_batch)
                rec["global_batch"] = global_batch
            if shape.name == "long_500k" and not cfg.supports_long_context:
                rec["skipped"] = ("full-attention arch: quadratic at 500k; "
                                  "skipped as in the reference")
                rec["seconds"] = time.time() - t0
                _write(out_path, rec)
                return rec
            rec.update(_run_lm(cfg, shape, ctx))
    except Exception as e:  # noqa: BLE001 — recorded, the sweep continues
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["seconds"] = round(time.time() - t0, 1)
    _write(out_path, rec)
    return rec


def _fake_args(cfg, shape, bundle, params, ctx):
    """The step's arguments as fake tensors on the rank's device: the
    whole batch (the step keeps the rank's share), zero moments placed by
    ``opt_state_specs``, the rank's caches."""
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    dev = ctx.device

    def real(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)

    if shape.kind == "train":
        batch = {k: real(v) for k, v in bundle.args[2].items()}
        return (params, AdamW().init(params, ctx), batch)
    if shape.kind == "prefill":
        return (params, {k: real(v) for k, v in bundle.args[1].items()})
    token = real(bundle.args[1])
    local = steps.local_batch({"token": token}, ctx)["token"]
    if cfg.is_encdec:
        from repro_torch.models import encdec
        caches = encdec.empty_caches(cfg, local.shape[0], shape.seq_len,
                                     device=dev, ctx=ctx)
    else:
        caches = Model(cfg, device=dev).init_caches(local.shape[0],
                                                   shape.seq_len, ctx)
    return (params, token, caches)


def _spec_param_bytes(cfg, ctx) -> int:
    """Bytes of the rank's parameter shards, from the sharding rules."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    shapes = steps.param_specs(cfg)
    specs = sharding.param_specs(shapes, ctx, cfg)
    total = 0
    for name, t in shapes.items():
        spec = sharding.guarded(specs[name], t.shape, ctx)
        shards = 1
        for p in spec:
            if p is not None:
                shards *= sharding.axes_size(ctx, p)
        total += t.numel() // shards * transformer.leaf_dtype(
            cfg, name).itemsize
    return total


def _run_lm(cfg, shape, ctx) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models import encdec, transformer
    from repro_torch.models.model import Model
    from repro_torch.roofline import analysis

    _register_flash_flops()
    bundle = steps.bundle_for(cfg, shape, ctx=ctx)
    dev = ctx.device
    tree = encdec.EncDec if cfg.is_encdec else transformer.Transformer
    with FakeTensorMode(allow_non_fake_inputs=True), fa_ops.card_route():
        model = Model(cfg, device=dev)
        params = model.shard(tree(cfg, {
            k: torch.empty(v.shape, dtype=v.dtype, device=dev)
            for k, v in bundle.args[0].items()}), ctx)
        args = _fake_args(cfg, shape, bundle, params, ctx)
        tracker = MemTracker()
        external = [params]
        if shape.kind == "train":
            external += [t.to_local() for m in (args[1].mu, args[1].nu)
                         for t in m.values()]
        tracker.track_external(*external)
        traffic = _Traffic()
        with tracker, FlopCounterMode(display=False) as flops, \
                CommDebugMode() as comm, traffic:
            bundle.fn(*args)
        peak = tracker.get_tracker_snapshot("peak")
    by_kind = next(iter(peak.values())) if peak else {}
    kinds = {"parameters": "Parameter", "gradients": "Gradient",
             "optimizer_state": "Other", "activations": "Activation",
             "temporaries": "Temp", "buffers": "Buffer"}
    memory = {k: int(by_kind.get(v, 0)) for k, v in kinds.items()}
    memory["peak_bytes"] = int(by_kind.get("Total", sum(memory.values())))
    memory["param_bytes_from_specs"] = _spec_param_bytes(cfg, ctx)
    total_flops = float(flops.get_total_flops())
    coll_bytes = float(sum(b for _, b in traffic.coll.values()))
    out = {"trace_ok": True, "step": bundle.description,
           "memory": memory,
           "over_card": memory["peak_bytes"] > CARD_BYTES,
           "flops": total_flops, "bytes": float(traffic.bytes),
           "collectives": {k: {"calls": c, "bytes": b}
                           for k, (c, b) in sorted(traffic.coll.items())},
           "collective_bytes": coll_bytes,
           "comm_debug_counts": {str(k): v for k, v in
                                 comm.get_comm_counts().items()},
           "roofline": analysis.roofline_terms(total_flops,
                                               float(traffic.bytes),
                                               coll_bytes),
           "model_flops": analysis.model_flops(cfg, shape),
           "params_total": analysis.total_params(cfg),
           "params_active": analysis.active_params(cfg)}
    out["useful_flops_ratio"] = out["model_flops"] / max(
        total_flops * ctx.mesh.size(), 1.0)
    return out


def _run_pixhomology(ctx, shape_name: str, overrides: dict | None,
                     device: torch.device) -> dict:
    """The paper's own workload: one rank's share of a sharded image batch
    through the port's ``sharded_plan``, run for real on ``device``."""
    if shape_name.startswith("ph_tiled"):
        return _run_pixhomology_tiled(shape_name, device)
    if shape_name.startswith("ph_hetero"):
        return _run_pixhomology_hetero(ctx, shape_name, device)
    from repro_torch.ph import PHConfig
    presets = {"ph_batch_1k": (512, 1024, 1024, 16384, 8192),
               "ph_batch_4k": (512, 4096, 4096, 65536, 32768)}
    b, h, w, k, f = presets[shape_name]
    config = PHConfig(max_features=f, max_candidates=k, auto_regrow=False,
                      merge_impl="boruvka")
    if overrides:
        config = config.replace(**overrides)
    local = max(1, b // ctx.dp_size)
    out = {"trace_ok": True, "images_per_device": local}
    out.update(_ph_share(config, (local, h, w), f, k, device))
    return out


def _ph_share(config, shape, f: int, k: int, device: torch.device) -> dict:
    """``sharded_plan`` of one rank's ``shape`` batch on ``device``: its live
    bytes (``tiling._LiveBytes``) and the program's counted bytes and
    operations per image (``ph_program_cost``) as roofline terms.  The
    images are the synthetic astro frames 0 .. m-1 (``data/astro.py``) at
    the engine's own thresholds, as the pipeline feeds them."""
    import numpy as np
    from repro_torch.core.tiling import _LiveBytes
    from repro_torch.data import astro
    from repro_torch.distributed.context import DistContext
    from repro_torch.ph import PHEngine
    from repro_torch.roofline import analysis

    engine = PHEngine(config, device=device)
    m, h, w = shape
    plan = engine.sharded_plan(DistContext((device,)), shape, torch.float32,
                               f, k)
    frames = np.stack([astro.generate_image(i, max(h, w))[:h, :w]
                       for i in range(m)])
    x = torch.from_numpy(frames).to(device)
    tv = torch.tensor([float("-inf") if t is None else t for t in
                       map(engine.auto_threshold, frames)],
                      dtype=torch.float32, device=device)
    before = _ph_launches()
    with _LiveBytes() as live:
        plan([x], [tv])
    launches = {k: n - before[k] for k, n in _ph_launches().items()}
    cost = analysis.ph_program_cost((h, w), "float32",
                                    engine._effective_config((h, w),
                                                             torch.float32),
                                    f, k)
    return {"memory": {"argument_bytes": x.numel() * 4 + m * 4,
                       "temp_bytes": live.peak,
                       "peak_bytes": x.numel() * 4 + m * 4 + live.peak},
            "roofline": analysis.roofline_terms(cost["flops"] * m,
                                                cost["bytes"] * m, 0.0),
            "program_cost_per_image": cost,
            "kernel_launches": launches,
            "plan_cache": engine.plan_stats()}


def _ph_launches() -> dict:
    """Each PH kernel's launches so far (its wrapper counts them; none on
    the host, where the plain versions run)."""
    from repro_torch.kernels.maxpool import kernel as kmp
    from repro_torch.kernels.ph_distance import kernel as kd
    from repro_torch.kernels.ph_phase_a import kernel as ka
    from repro_torch.kernels.ph_phase_c import kernel as kc
    return {"ph_phase_a": ka.LIBRARY.launches,
            "ph_phase_c": kc.LIBRARY.launches,
            "maxpool": kmp.LIBRARY.launches,
            "ph_distance": kd.LIBRARY.launches}


def _run_pixhomology_hetero(ctx, shape_name: str,
                            device: torch.device) -> dict:
    """One cached sharded plan per shape bucket: each bucket's footprint
    and the pad overhead of its sizes (``PHConfig.bucket_rounding``)."""
    from repro_torch.ph import PHConfig
    from repro_torch.pipeline.scheduler import bucket_shape
    presets = {"ph_hetero_1k": ((320, 512, 1024), 16384, 8192)}
    sizes, k, f = presets[shape_name]
    config = PHConfig(max_features=f, max_candidates=k, auto_regrow=False,
                      merge_impl="boruvka")
    out: dict = {"trace_ok": True, "buckets": {}}
    measured: dict = {}
    for size in sizes:
        hb, wb = bucket_shape((size, size), "pow2")
        cell = measured.get((hb, wb))
        if cell is None:
            cell = measured[hb, wb] = _ph_share(config, (1, hb, wb), f, k,
                                                device)
        out["buckets"][f"{size}->bucket{hb}x{wb}"] = {
            "memory": cell["memory"],
            "kernel_launches": cell["kernel_launches"],
            "pad_overhead": round(hb * wb / (size * size) - 1.0, 4)}
    return out


def _run_pixhomology_tiled(shape_name: str, device: torch.device) -> dict:
    """The per-tile phases' footprint at the same tile under two image
    sizes: it must not grow with the image (``per_tile_cost``)."""
    from repro_torch.core.tiling import per_tile_cost
    presets = {"ph_tiled_1k": (256, 256, 16, 256),
               "ph_tiled_4k": (512, 512, 64, 1024)}
    th, tw, n_small, n_big = presets[shape_name]
    small = per_tile_cost((th, tw), torch.float32, n_tiles=n_small,
                          device=device)
    big = per_tile_cost((th, tw), torch.float32, n_tiles=n_big,
                        device=device)
    return {
        "trace_ok": True, "tile_shape": [th, tw],
        "per_tile_small_image": small, "per_tile_big_image": big,
        "phase_a_peak_invariant": (small["phase_a"]["peak_bytes_est"]
                                   == big["phase_a"]["peak_bytes_est"]),
        "phase_b_peak_ratio": round(
            big["phase_b"]["peak_bytes_est"]
            / max(small["phase_b"]["peak_bytes_est"], 1), 3)}


def _write(path: Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=float))


def _status(rec: dict) -> str:
    return ("skip" if rec.get("skipped")
            else "ok" if rec.get("trace_ok") else "ERR")


def sweep(multi_pod_too: bool, archs=None, shapes=None, force=False,
          device: str | None = None) -> int:
    """One subprocess per cell (a fake group per process; resumable)."""
    from repro_torch.configs.base import cells

    todo = []
    meshes = [False] + ([True] if multi_pod_too else [])
    for arch, shape_name, _skip in cells(archs, shapes):
        for mp in meshes:
            todo.append((arch, shape_name, mp))
    for mp in meshes:
        todo.append(("pixhomology", "ph_batch_1k", mp))
    todo.append(("pixhomology", "ph_tiled_1k", False))
    todo.append(("pixhomology", "ph_hetero_1k", False))

    results = []
    for i, (arch, shape_name, mp) in enumerate(todo):
        mesh_name = "2x16x16" if mp else "16x16"
        out = ARTIFACTS / f"{arch}__{shape_name}__{mesh_name}.json"
        if out.exists() and not force:
            rec = json.loads(out.read_text())
            print(f"[{i + 1}/{len(todo)}] cached {out.name}: "
                  f"{_status(rec)}", flush=True)
            results.append(rec)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape_name, "--out", str(out)]
        if mp:
            cmd.append("--multi-pod")
        if device:
            cmd += ["--device", device]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=3600)
        if out.exists():
            rec = json.loads(out.read_text())
        else:
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "error": f"subprocess died: {proc.stderr[-2000:]}"}
            _write(out, rec)
        status = _status(rec)
        print(f"[{i + 1}/{len(todo)}] {out.name}: {status} "
              f"({time.time() - t0:.0f}s)", flush=True)
        if status == "ERR":
            print("    ", rec.get("error", "?")[:300], flush=True)
        results.append(rec)

    n_ok = sum(1 for r in results if r.get("trace_ok"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    n_err = len(results) - n_ok - n_skip
    print(f"SWEEP DONE: {n_ok} ok, {n_skip} skipped, {n_err} errors",
          flush=True)
    return 1 if n_err else 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--multi-pod-too", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--archs", nargs="*")
    ap.add_argument("--shapes", nargs="*")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value")
    ap.add_argument("--global-batch", type=int)
    ap.add_argument("--device",
                    help="cpu: the host (default: the CUDA device)")
    args = ap.parse_args()
    resolve_device(args.device)

    if args.sweep:
        sys.exit(sweep(args.multi_pod_too, args.archs, args.shapes,
                       args.force, args.device))

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    out = Path(args.out) if args.out else \
        ARTIFACTS / f"{args.arch}__{args.shape}__{mesh_name}.json"
    rec = run_cell(args.arch, args.shape, args.multi_pod, out,
                   overrides or None, global_batch=args.global_batch,
                   device=args.device)
    ok = rec.get("trace_ok") or rec.get("skipped")
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=1, default=float))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

"""Closed loop, one call in flight: a survey reduction job that submits
its next batch when the last one returns.

Set-up draws the mix's pool of distinct frames on the card from the seed
(the configuration's recipe), takes their thresholds there (the mix's
statistic, or none), moves the frames to pageable host memory, where a
FITS reader leaves them, builds the engine and makes one warm pass over
the whole pool, so the engine's regrow memo and plan cache are settled.
The window then cycles through the pool, ``frames_per_call`` frames a
call, for ``seconds``; a call ends when every diagram it returns is in
host memory.  A seeded reservoir keeps ``sample_calls`` calls' inputs
and diagrams for the check after the window (``run.sample``: pairs of
``(frames, thresholds)`` and the diagram, one inputs object a batch).
"""
from __future__ import annotations

import dataclasses
import random
import sys
import time
import traceback

import harness.device as devmod
import harness.spec as spec
import harness.threshold as threshold


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    frames: int
    pixels: int
    regrows: int
    failed: bool


def setup(run, driver):
    cfg, mix = run.cell.config, run.cell.traffic
    import torch
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        devmod.synchronize(run.device)
        now = time.perf_counter()
        parts[name] = round(now - t, 3)
        t = now

    recipe = spec.load_module("recipes", cfg["frame"]["recipe"],
                              run.root / "bench")
    pool = recipe.draw(cfg["frame"], int(mix["pool_frames"]), run.seed,
                       run.device)
    lap("draw")
    run.thresholds = threshold.thresholds(pool, mix["threshold"])
    lap("thresholds")
    run.pool = pool.cpu().numpy()
    del pool
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    lap("to_host")
    engine = driver.build(cfg, run.device, run.overrides)
    batches = _batches(run)
    driver.call(engine, *batches[0])
    lap("first_call")
    for batch in batches[1:]:
        driver.call(engine, *batch)
    lap("warm_pass")
    print(f"bench: set-up parts (s): {parts}", file=sys.stderr)
    return engine


def _batches(run) -> list[tuple]:
    """The pool cut into calls: ``(frames, thresholds)`` views, in order."""
    per = int(run.cell.traffic["frames_per_call"])
    n = run.pool.shape[0]
    if n % per:
        raise ValueError("pool_frames must be a multiple of frames_per_call")
    return [(run.pool[k:k + per],
             None if run.thresholds is None else run.thresholds[k:k + per])
            for k in range(0, n, per)]


def window(run, driver, engine, tracer=None) -> list[Call]:
    """Calls for ``run.seconds``; the last one runs to its end.  A traced
    run goes on, if need be, until its profiled slice is complete."""
    mix = run.cell.traffic
    batches = _batches(run)
    keep = int(mix["sample_calls"])
    rng = random.Random(f"sample/{run.seed}")
    run.sample = []
    calls: list[Call] = []
    t_end = time.perf_counter() + run.seconds
    i = 0
    while True:
        batch = batches[i % len(batches)]
        frames, tv = batch
        t0 = time.perf_counter()
        failed, regrows, out = False, 0, None
        try:
            if tracer is None:
                out, regrows = driver.call(engine, frames, tv)
            else:
                with tracer.call(i):
                    out, regrows = driver.call(engine, frames, tv)
        except Exception:          # a failed call counts; the run goes on
            traceback.print_exc(file=sys.stderr)
            failed = True
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, frames.shape[0],
                          int(frames.shape[0] * frames.shape[1]
                              * frames.shape[2]), regrows, failed))
        if out is not None:
            # Reservoir: every call is equally likely to be checked.
            item = (batch, out)
            if len(run.sample) < keep:
                run.sample.append(item)
            else:
                j = rng.randrange(i + 1)
                if j < keep:
                    run.sample[j] = item
        i += 1
        if t1 >= t_end and (tracer is None
                            or i >= tracer.slice_calls.stop):
            return calls

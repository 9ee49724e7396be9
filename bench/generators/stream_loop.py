"""Closed loop over a source-injection stream, one call in flight: one
field processed again and again, each realisation changing a few of its
tiles (``recipes/star_field_stream.py``).

Set-up draws the base field and a pool of ``pool_frames`` realisations on
the card from the seed, takes one threshold for the whole stream (the
mix's statistic of the base field), moves the frames to pageable host
memory, builds the engine, runs the base once, which puts the field's
epoch in the frame store, and makes one warm pass over the pool.  The
window is ``closed_loop``'s over the realisations alone (its ``Call``,
``_batches`` and ``window``), so the sampled inputs and the check are the
same.  With a pool larger than the frame store no realisation is found
whole: each call is a partial hit, and each hit keeps the base it matched
at the store's fresh end.
"""
from __future__ import annotations

import sys
import time

import harness.device as devmod
import harness.spec as spec
import harness.threshold as threshold

_loop = spec.load_module("generators", "closed_loop")
Call, _batches, window = _loop.Call, _loop._batches, _loop.window


def grid_of(config: dict):
    """The tile grid the injections follow: the engine's explicit grid,
    else the one the recipe states (the engine's auto grid)."""
    tile = config["engine"].get("tile") or {}
    return tile.get("grid") or config["frame"]["inject"]["grid"]


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
    frames, _ = recipe.draw(cfg["frame"], int(mix["pool_frames"]),
                            run.seed, run.device, grid_of(cfg))
    lap("draw")
    t_stream = threshold.thresholds(frames[:1], mix["threshold"])[0]
    lap("threshold")
    host = frames.cpu().numpy()
    del frames
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    run.base, run.pool = host[:1], host[1:]
    run.thresholds = [t_stream] * run.pool.shape[0]
    lap("to_host")
    engine = driver.build(cfg, run.device, run.overrides)
    driver.call(engine, run.base, [t_stream])
    lap("base_call")
    for batch in _batches(run):
        driver.call(engine, *batch)
    lap("warm_pass")
    print(f"bench: set-up parts (s): {parts}", file=sys.stderr)
    return engine


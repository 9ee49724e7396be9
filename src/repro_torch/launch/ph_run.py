"""Distributed PixHomology pipeline driver (the paper's end-to-end job).

`python -m repro_torch.launch.ph_run --images 64 --size 512 --strategy part_LPT`

The port's counterpart of ``repro.launch.ph_run``: the full paper pipeline
on one executor on the CUDA device (``--device cuda:k`` picks the card,
``--device cpu`` runs it on the host): LPT (or another Variant-3
strategy) scheduling, executor self-loading (Variant 1), threshold
filtering (Variant 2), work-log fault tolerance, per-image persistence
diagram summaries, through the :mod:`repro_torch.ph` facade
(``PHConfig.from_flags`` + ``PHEngine``).  It prints the reference's JSON
block.  ``--autotune`` reads the tuned knobs of each image shape from the
cache :mod:`repro_torch.roofline.autotune` writes.

Heterogeneous datasets: ``--sizes 256 512 1024`` cycles image sizes over
``--images`` ids (shape-bucketed rounds, ``--bucket-rounding``); images
above ``--max-tile-pixels`` stream through the tiled path; the loader
thread prefetches ``--prefetch-rounds`` rounds ahead (``--no-prefetch``
serializes load and compute).

``--overlap`` turns on the overlap engine (:mod:`repro_torch.ph.overlap`):
``--overlap-depth`` rounds in flight, round batches staged in reused
pinned pool buffers, the computation, overflow check and result copy
deferred to a harvest thread so the dispatch loop never blocks on the
device.  The opt-out
toggles (``--no-donate`` / ``--no-async-overflow`` /
``--no-async-harvest``) each imply ``--overlap`` with that one feature
off.  Every combination is bit-identical to the synchronous path.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.ph import PHConfig, PHEngine
from repro_torch.pipeline.driver import FailureInjector


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the executor (default: the "
                         "CUDA device; 'cpu' runs on the host)")
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--sizes", type=int, nargs="*", default=None,
                    help="heterogeneous dataset: cycle these sizes over "
                         "the image ids (overrides --size)")
    ap.add_argument("--bucket-rounding", dest="bucket_rounding",
                    choices=["exact", "pow2"])
    ap.add_argument("--prefetch-rounds", dest="prefetch_rounds", type=int)
    ap.add_argument("--no-prefetch", action="store_true",
                    help="serialize loading and compute (prefetch_rounds=0)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap engine: pinned staging pool, the "
                         "computation and regrow deferred to a harvest "
                         "thread, results streamed to pinned host memory "
                         "(bit-identical to the synchronous path)")
    ap.add_argument("--overlap-depth", dest="overlap_depth", type=int,
                    help="staging-ring depth: device-staged + in-flight "
                         "rounds allowed ahead of the harvest (implies "
                         "--overlap; default 2)")
    ap.add_argument("--no-donate", action="store_true",
                    help="stage every round in fresh buffers instead of "
                         "reusing the staging pool's (implies --overlap)")
    ap.add_argument("--no-async-overflow", action="store_true",
                    help="block on every overflow check at dispatch time "
                         "instead of streaming it (implies --overlap)")
    ap.add_argument("--no-async-harvest", action="store_true",
                    help="materialize results on the dispatch thread "
                         "instead of a harvest thread (implies --overlap)")
    ap.add_argument("--strategy", default="part_LPT",
                    choices=["part_executors", "part_images", "part_LPT"])
    ap.add_argument("--filter", default="filter_std",
                    choices=["vanilla", "filter_light", "filter_std",
                             "filter_heavy"])
    ap.add_argument("--filtration", default="superlevel",
                    choices=["superlevel", "sublevel"],
                    help="filtration direction: superlevel (paper default, "
                         "births at maxima) or sublevel (births at minima; "
                         "runs the same machinery on the exactly negated "
                         "image — floating dtypes only)")
    ap.add_argument("--work-log")
    ap.add_argument("--inject-failure", type=int, nargs="*", default=[],
                    help="round indices to fail once (recovery demo)")
    ap.add_argument("--max-features", type=int, default=8192)
    ap.add_argument("--max-candidates", type=int, default=32768)
    ap.add_argument("--candidate-mode", choices=["exact", "paper"])
    ap.add_argument("--merge-impl", choices=["scan", "boruvka"])
    ap.add_argument("--merge-keys", dest="merge_keys",
                    choices=["packed", "rank"],
                    help="phase-C total-order keys: packed (value, index) "
                         "int64 bit-keys (no full-image argsort; falls "
                         "back to rank for > 32-bit dtypes) or dense "
                         "argsort ranks")
    ap.add_argument("--phase-a-impl", dest="phase_a_impl",
                    choices=["fused", "pooled"],
                    help="stage-A implementation: fused strip kernel "
                         "(+compacted-frontier phase B) or the unfused "
                         "pooled baseline")
    ap.add_argument("--strip-rows", dest="strip_rows", type=int,
                    help="fused phase-A strip height")
    ap.add_argument("--phase-c-impl", dest="phase_c_impl",
                    choices=["fused", "xla"],
                    help="stage-C merge under merge_impl=boruvka: fused "
                         "compact-instance kernel or the plain full-image "
                         "Boruvka (bit-identical either way)")
    ap.add_argument("--tournament-width", dest="tournament_width", type=int,
                    help="blockwise top-k tournament width (>= 2; any "
                         "width is bit-identical)")
    ap.add_argument("--autotune", action="store_true",
                    help="fold cached autotuned (strip_rows, phase_c_block, "
                         "tournament_width) into plans per image shape "
                         "(repro_torch.roofline.autotune disk cache; "
                         "missing entries fall back to the flags above)")
    ap.add_argument("--autotune-cache", dest="autotune_cache",
                    help="autotune cache path (default: "
                         "artifacts/autotune_cache_torch.json)")
    ap.add_argument("--no-regrow", action="store_true",
                    help="surface overflow instead of auto-regrowing")
    ap.add_argument("--tile-grid", dest="tile_grid", metavar="RxC",
                    help="halo-tiled path: fixed tile grid, e.g. 2x2")
    ap.add_argument("--tile-max-features", dest="tile_max_features",
                    type=int)
    ap.add_argument("--tile-max-candidates", dest="tile_max_candidates",
                    type=int)
    ap.add_argument("--max-tile-pixels", dest="max_tile_pixels", type=int,
                    help="route images above this pixel count through the "
                         "tiled path (also the auto-grid tile budget)")
    args = ap.parse_args()
    if args.max_tile_pixels is None and (
            args.tile_grid or args.tile_max_features
            or args.tile_max_candidates):
        # An explicit tile flag is a request for the tiled path: lower the
        # routing bound so this run's images actually take it (the TileSpec
        # default of 1<<20 px would silently keep small images whole).
        top = max(args.sizes) if args.sizes else args.size
        args.max_tile_pixels = top * top - 1

    config = PHConfig.from_flags(args)
    engine = PHEngine(config, device=args.device)
    injector = (FailureInjector(args.inject_failure)
                if args.inject_failure else None)
    if args.sizes:
        images = [(i, args.sizes[i % len(args.sizes)])
                  for i in range(args.images)]
    else:
        images = list(range(args.images))
    res = engine.run_distributed(
        images, image_size=args.size,
        strategy=args.strategy, work_log=args.work_log,
        failure_injector=injector, verbose=True)
    total_objects = sum(d["count"] for d in res.diagrams.values())
    stats = engine.plan_stats()
    out = {
        "config": json.loads(config.to_json()),
        "images": len(res.diagrams), "rounds": res.rounds,
        "failures_recovered": res.failures, "elapsed_s": round(res.elapsed_s, 2),
        "total_objects": total_objects,
        "mean_objects_per_image": total_objects / max(len(res.diagrams), 1),
        "plan_cache": stats,
    }
    if config.overlap is not None and config.overlap.enabled:
        out["overlap"] = engine.overlap_counters.snapshot()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""End-to-end distributed PixHomology pipeline on the PyTorch port.

    python examples/distributed_ph_torch.py                  # on the card
    PYTHONPATH=src python examples/distributed_ph_torch.py --device cpu

The counterpart of ``examples/distributed_ph.py`` through
``repro_torch.ph``: the paper's production job on the engine's device
(``PHEngine.run_distributed``):

  * Variant 1 (load_self): executors generate/load their own images,
  * Variant 2 (filter_std): per-image threshold, background excluded,
  * Variant 3 (part_LPT): cost-estimated LPT scheduling,
  * fault tolerance: an injected executor failure + work-log recovery,
  * output: per-image persistence summaries (object counts, top births).

The work log (``--work-log``, under ``build/`` by default) starts empty,
so each run computes every image and recovers from its injected failure.
It takes the Boruvka merge, whose best-edge rounds run the kernel on
the card (the default scan merge is sequential).
``main`` returns what it prints, with every image's summary.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.pipeline.driver import FailureInjector  # noqa: E402
from repro_torch.ph import FilterLevel, PHConfig, PHEngine  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--work-log",
                    default=str(ROOT / "build" / "ph_worklog_torch.jsonl"))
    args = ap.parse_args(argv)

    config = PHConfig(max_features=8192, max_candidates=32768,
                      filter_level=FilterLevel.STD,
                      merge_impl="boruvka")
    engine = PHEngine(config, device=args.device)
    log = Path(args.work_log)
    log.parent.mkdir(parents=True, exist_ok=True)
    log.unlink(missing_ok=True)

    result = engine.run_distributed(
        list(range(12)), image_size=256, strategy="part_LPT",
        work_log=str(log),
        failure_injector=FailureInjector([2]),   # round 2 dies once
        verbose=True)

    out = {"images": len(result.diagrams), "rounds": result.rounds,
           "failures": result.failures, "elapsed_s": result.elapsed_s,
           "plan_cache": engine.plan_stats(), "diagrams": result.diagrams}
    print(f"\ncompleted {out['images']} images in {out['rounds']} "
          f"rounds, recovered from {out['failures']} failure(s), "
          f"{out['elapsed_s']:.1f}s")
    print(f"plan cache: {out['plan_cache']}")
    sample = result.diagrams[0]
    print("image 0 summary:", json.dumps(sample, indent=1, default=float)[:400])
    return out


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
entry driver, frame recipe, reference and metrics are found by name from
``BENCHMARK.json`` (``harness/spec.py``).  Set-up draws the mix's frames
from the seed and warms every shape the window will use; the window
measures for ``--seconds``; then the sampled diagrams are checked against
the plain reference.  With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from spans, counters and a profiled slice of the window.

Exit codes: 0 with a result line (``correct`` may be false), 3 when the
cell's CUDA devices are missing, 4 when JAX or the JAX package is loaded
once everything before the result line has run; any other failure
raises, and no result line is printed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

import harness.device as devmod  # noqa: E402
import harness.guard as guard  # noqa: E402
import harness.spec as spec  # noqa: E402
from harness.tracing import Tracer  # noqa: E402


@dataclasses.dataclass
class Run:
    """Everything one run measured; the metric modules read it."""

    root: Path
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    overrides: dict | None = None
    setup_s: float = 0.0
    pool: object = None
    thresholds: list | None = None
    calls: list = dataclasses.field(default_factory=list)
    sample: list = dataclasses.field(default_factory=list)
    plan_builds: int = 0
    setup_peak: int = 0
    window_peak: int = 0
    tracer: Tracer | None = None

    def slice_frames(self) -> int:
        r = self.tracer.slice_calls
        return sum(c.frames for c in self.calls[r.start:r.stop])


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def verify(run) -> tuple[dict, dict]:
    """The check's numbers summed over the sampled calls, and its limits.
    The configuration's reference module gives both: ``expected(inputs,
    device)`` once for each distinct inputs object the generator sampled,
    ``compare(expected, output)`` for each sampled call, and ``LIMITS``."""
    ref = spec.load_module("references", run.cell.config["reference"],
                           run.root / "bench")
    want: dict[int, object] = {}
    numbers = dict.fromkeys(ref.LIMITS, 0)
    for inputs, output in run.sample:
        if id(inputs) not in want:
            want[id(inputs)] = ref.expected(inputs, run.device)
        for k, v in ref.compare(want[id(inputs)], output).items():
            numbers[k] += v
    return numbers, ref.LIMITS


def metric_values(run, metrics) -> dict:
    """Each metric a module reads; one with no finite reading is left
    out of the line."""
    out = {}
    for m in metrics:
        v = m.module.read(run)
        if v is not None and math.isfinite(v):
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def main(argv=None, *, root: Path | None = None, require=None,
         overrides: dict | None = None, t_start: float | None = None
         ) -> int:
    args = parse(argv)
    root = BENCH_DIR.parent if root is None else Path(root)
    cell = spec.load_cell(args.workload, root, root / "bench")
    device = (require or devmod.require_cuda)(cell.chips)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    driver = spec.load_module("drivers", cell.config["driver"],
                              root / "bench")
    gen = spec.load_module("generators", cell.traffic["generator"],
                           root / "bench")
    run = Run(root, cell, args.seed, args.seconds, bool(args.trace), device,
              overrides)

    engine = gen.setup(run, driver)
    plans0 = engine.plan_stats()["traces"]
    run.setup_s = time.perf_counter() - (T_START if t_start is None
                                         else t_start)
    run.setup_peak = devmod.reset_peak(device)
    if run.trace:
        n = int(cell.traffic["trace_calls"])
        run.tracer = Tracer(device, range(1, 1 + n))
        for m in cell.per_layer:
            if hasattr(m.module, "install"):
                m.module.install(run.tracer, engine)
    try:
        run.calls = gen.window(run, driver, engine, run.tracer)
    finally:
        if run.tracer is not None:
            run.tracer.close()
    devmod.synchronize(device)
    run.window_peak = devmod.peak(device)
    run.plan_builds = engine.plan_stats()["traces"] - plans0

    del engine
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    numbers, limits = verify(run)
    failed = sum(c.failed for c in run.calls)
    checked = len(run.sample)
    correct = (all(numbers[k] <= lim for k, lim in limits.items())
               and failed == 0 and checked > 0)

    metrics = metric_values(run, cell.per_layer if run.trace
                            else cell.end_to_end)
    dev = devmod.record(device, cell.chips,
                        max(run.setup_peak, run.window_peak))
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace:
        tr = run.tracer.trace
        dev["busy_s"] = tr.busy_us() * 1e-6 if tr is not None else 0.0
        dev["window_s"] = tr.window_us * 1e-6 if tr is not None else 0.0
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    result["checks"]["calls_checked"] = {"value": checked, "at_least": 1}

    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"bench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, v in numbers.items():
        print(f"check {k} = {v} (limit {limits[k]})", file=sys.stderr)
    print(f"check calls_checked = {checked} (at least 1)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

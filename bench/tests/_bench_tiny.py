"""A checkout-shaped directory whose cells are the real ones at a tiny
frame size, so a whole run fits a CPU test: the benchmark's own
directories are linked, and the configurations and mixes are the real
files with their sizes cut."""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (BENCH, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

SIZES = {"paper_10k": 64, "survey_4k": 48}
LINKED = ("harness", "drivers", "generators", "recipes", "references",
          "e2e", "metrics")


def tiny_root(tmp: Path, *, size: dict | None = None,
              pool: int | None = None, sample_calls: int | None = None
              ) -> Path:
    """``tmp`` laid out as a checkout: ``BENCHMARK.json``, ``src`` and
    ``bench`` with tiny configurations and mixes."""
    sizes = dict(SIZES, **(size or {}))
    (tmp / "bench" / "configs").mkdir(parents=True)
    (tmp / "bench" / "traffic").mkdir()
    os.symlink(ROOT / "src", tmp / "src")
    for d in LINKED:
        os.symlink(BENCH / d, tmp / "bench" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["frame"]["size"] = sizes[c["name"]]
        cfg["frame"]["density_per_px"] *= 8     # stars still overlap
        if "tile" in cfg["engine"]:
            cfg["engine"]["tile"] = {"grid": [2, 2]}
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        src = BENCH / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(src.read_text())
        if pool is not None:
            mix["pool_frames"] = pool * mix["frames_per_call"]
        if sample_calls is not None:
            mix["sample_calls"] = sample_calls
        (tmp / "bench" / "traffic" / src.name).write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cpu(chips):
    import torch
    return torch.device("cpu")


def run_cell(root: Path, workload: str, *, seed=7, seconds=0.5, trace=0,
             capsys=None, overrides=None):
    """``bench/run.py`` on the CPU: ``(exit code, last stdout line as a
    dict or None)``."""
    import run as bench_run
    rc = bench_run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        root=root, require=cpu, overrides=overrides)
    if capsys is None:
        return rc, None
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None

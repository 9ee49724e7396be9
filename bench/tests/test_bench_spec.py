"""BENCHMARK.json against the contract's shape, and a configuration, a
mix and a metric added as new files, found by name."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

import _bench_tiny as tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # A full check of 24 cells must fit its 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"].startswith("bench/")
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] == []
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    for text in (cfg["source"], cfg["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1
    assert len(w["why"]) <= 200
    assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    reported = [m for m in BENCH["end_to_end"]
                if "workloads" not in m or w["name"] in m["workloads"]]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) > 1
    assert any("workloads" not in m or w["name"] in m["workloads"]
               for m in BENCH["per_layer"])


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "bench" / "e2e" / f"{m['name']}.py").is_file()
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


def test_file_size():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_new_files_are_found_by_name(tmp_path, capsys):
    """A new configuration, mix and end-to-end metric: new files and new
    entries only, and the run reports the new metric."""
    root = tiny.tiny_root(tmp_path)
    e2e = root / "bench" / "e2e"
    e2e.unlink()
    shutil.copytree(tiny.BENCH / "e2e", e2e)
    (e2e / "frames_per_s.py").write_text(
        "def read(run):\n"
        "    return sum(c.frames for c in run.calls) / "
        "(run.calls[-1].t1 - run.calls[0].t0)\n")
    cfg = json.loads((root / "bench/configs/survey_4k.json").read_text())
    cfg.update(name="survey_wide", assumed=[])
    cfg["frame"]["size"] = 40
    (root / "bench/configs/survey_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "bench/traffic/std1_pool8.json").read_text())
    mix.update(frames_per_call=3, pool_frames=6)
    (root / "bench/traffic/std3_pool6.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "survey_wide", "source": "test",
                             "file": "bench/configs/survey_wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "survey_wide.std3",
                               "config": "survey_wide",
                               "traffic": "std3_pool6", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["survey_wide.std3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = tiny.run_cell(root, "survey_wide.std3", capsys=capsys)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["frames_per_s"]["value"] > 0
    assert line["checks"]["calls_checked"]["value"] >= 1


GENERATOR = """
import collections, time
Call = collections.namedtuple("Call", "t0 t1 frames pixels regrows failed")

def setup(run, driver):
    import torch
    g = torch.Generator().manual_seed(run.seed)
    run.pool = torch.rand(3, 24, 24, generator=g).numpy()
    return driver.build(run.cell.config, run.device, run.overrides)

def window(run, driver, engine, tracer=None):
    calls, t_end = [], time.perf_counter() + run.seconds
    while True:
        t0 = time.perf_counter()
        out, regrows = driver.call(engine, run.pool, None)
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, 3, run.pool.size, regrows, False))
        run.sample = [({"frames": run.pool}, out[4])]
        if t1 >= t_end:
            return calls
"""

REFERENCE = """
import torch
LIMITS = {"count_gap": 0}

def expected(inputs, device):
    f = torch.from_numpy(inputs["frames"])
    h, w = f.shape[1:]
    pad = torch.full((f.shape[0], h + 2, w + 2), -float("inf"))
    pad[:, 1:-1, 1:-1] = f
    peak = torch.ones_like(f, dtype=torch.bool)
    for dr in (0, 1, 2):
        for dc in (0, 1, 2):
            if (dr, dc) != (1, 1):
                peak &= f > pad[:, dr:dr + h, dc:dc + w]
    return peak.sum(dim=(1, 2))

def compare(expected, counts):
    return {"count_gap": int((expected - counts).abs().sum())}
"""


@pytest.mark.parametrize("altered", [False, True])
def test_another_sample_layout_runs_unchanged(tmp_path, capsys, altered):
    """A generator whose sampled inputs are a dict and whose outputs are
    the feature counts alone, checked by a reference of its own (strict
    local maxima of a float frame): new files and entries only."""
    root = tiny.tiny_root(tmp_path)
    for kind, name, body in (("generators", "whole_pool", GENERATOR),
                             ("references", "local_maxima", REFERENCE)):
        d = root / "bench" / kind
        d.unlink()
        shutil.copytree(tiny.BENCH / kind, d)
        (d / f"{name}.py").write_text(body)
    if altered:
        drivers = root / "bench" / "drivers"
        drivers.unlink()
        shutil.copytree(tiny.BENCH / "drivers", drivers)
        (drivers / "run_batch_plus_one.py").write_text(
            "import harness.ph_engine as ph\n"
            "from harness.ph_engine import build  # noqa: F401\n"
            "def call(engine, frames, thresholds):\n"
            "    d = engine.run_batch(frames, thresholds, dedupe=False)\n"
            "    out = ph.host_diagram(d.diagram)\n"
            "    return (*out[:4], out[4] + 1, *out[5:]), 0\n")
    cfg = json.loads((root / "bench/configs/survey_4k.json").read_text())
    cfg.update(name="survey_counts", reference="local_maxima")
    if altered:
        cfg["driver"] = "run_batch_plus_one"
    (root / "bench/configs/survey_counts.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/whole_pool.json").write_text(
        json.dumps({"generator": "whole_pool", "trace_calls": 1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "survey_counts", "source": "test",
                             "file": "bench/configs/survey_counts.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "survey_counts.whole",
                               "config": "survey_counts",
                               "traffic": "whole_pool", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = tiny.run_cell(root, "survey_counts.whole", capsys=capsys)
    assert rc == 0 and line["correct"] is not altered
    assert set(line["checks"]) == {"count_gap", "calls_checked"}
    assert (line["checks"]["count_gap"]["value"] > 0) is altered


def test_unknown_workload():
    import harness.spec as spec
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell", ROOT, ROOT / "bench")

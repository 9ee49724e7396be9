"""The port's span and counter recorder (repro_torch.telemetry) on the
engine's CPU paths.

Off, the recorder is a shared no-op that opens no profiler range and
makes no CUDA event.  On, each public entry is one root with its stages
nested under it (also across a harvest thread), the ``readbacks`` counter
equals the loops' own counts plus the fixed sites, every stage span is a
``ph.<name>`` range of a profiler trace with the same nesting, and the
diagrams are bitwise those of a run with the recorder off.  Frames of
32² to 64² from a numpy seed; nothing here needs the card.
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core import grid as grid_mod
from repro_torch.core import parallel_merge
from repro_torch.ph import OverlapSpec, PHConfig, PHEngine, TileSpec

TILED_STAGES = {"prep", "check_finite", "cast", "upload", "threshold",
                "tiles.split", "tiles.phase_ab", "tiles.ring_table",
                "tiles.seam_merge", "dispatch", "overflow_check"}
WHOLE_STAGES = {"keys", "phase_a", "phase_b", "candidates", "phase_c",
                "dispatch", "overflow_check", "prep", "check_finite"}


def _frames(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size)).astype(np.float32)


def _engine(**kw):
    return PHEngine(PHConfig(merge_impl="boruvka", **kw), device="cpu")


# Each entry: (engine config, call, calls made, stages every call has).
ENTRIES = {
    "run": (dict(), lambda e: [e.run(_frames(1, 32)[0], 0.5)],
            WHOLE_STAGES | {"threshold"}),
    "run_tiled": (dict(tile=TileSpec(grid=(2, 2))),
                  lambda e: [e.run_tiled(_frames(1, 64)[0], 0.5),
                             e.run_tiled(_frames(1, 64, 1)[0], 0.5)],
                  TILED_STAGES),
    "run_batch": (dict(), lambda e: [e.run_batch(_frames(2, 32),
                                                 dedupe=False),
                                     e.run_batch(_frames(2, 32, 1),
                                                 dedupe=False)],
                  WHOLE_STAGES | {"stage", "upload"}),
}


@pytest.fixture
def recorder():
    telemetry.reset()
    telemetry.enable()
    try:
        yield telemetry
    finally:
        telemetry.disable()
        telemetry.reset()


def _diagrams(results):
    return [[f.numpy() for f in r.diagram] for r in results]


def test_off_is_a_shared_noop(monkeypatch):
    """Off: one shared object, nothing recorded, no profiler range and
    no CUDA event made, and the diagram is the engine's."""
    telemetry.disable()
    telemetry.reset()
    assert telemetry.span("a") is telemetry.span("b", "cpu") \
        is telemetry.call("c")

    def refuse(*args, **kwargs):
        raise AssertionError("made while the recorder is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    cfg, entry, _ = ENTRIES["run_tiled"]
    entry(_engine(**cfg))
    telemetry.count("readbacks")
    telemetry.readback()
    assert telemetry.snapshot() == {"spans": [], "counters": {}}


def _check_calls(spans, n_calls, stages):
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.root]
    assert len(roots) == n_calls
    assert len({r.call for r in roots}) == n_calls
    for s in spans:
        assert s.call in {r.call for r in roots}
        if s.root:
            continue
        parent = by_id[s.parent]
        assert parent.call == s.call
        assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
    for r in roots:
        names = {s.name for s in spans if s.call == r.call and not s.root}
        assert stages <= names, stages - names


@pytest.mark.parametrize("name", list(ENTRIES))
def test_one_root_per_call_with_its_stages(recorder, name):
    cfg, entry, stages = ENTRIES[name]
    eng = _engine(**cfg)
    off = entry(eng)        # plans built and capacities memoized first
    recorder.reset()
    on = entry(eng)
    spans = recorder.snapshot()["spans"]
    _check_calls(spans, len(on), stages)
    assert {s.name for s in spans if s.root} == {name}
    for a, b in zip(_diagrams(off), _diagrams(on)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_async_batch_resolved_on_another_thread_keeps_its_id(recorder):
    """Under the overlap engine the computation runs in ``resolve()``;
    resolved on a harvest thread, its stages carry the dispatching
    call's id."""
    eng = _engine(overlap=OverlapSpec())
    pending = eng.run_batch_async(_frames(2, 32), dedupe=False)
    roots = [s for s in recorder.snapshot()["spans"] if s.root]
    assert [r.name for r in roots] == ["run_batch_async"]
    got = {}
    worker = threading.Thread(target=lambda: got.setdefault(
        "res", pending.resolve()))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and "res" in got
    spans = recorder.snapshot()["spans"]
    late = [s for s in spans if s.t0_ns > roots[0].t1_ns]
    assert {"dispatch", "phase_a", "phase_c", "overflow_check"} <= {
        s.name for s in late}
    assert {s.call for s in spans} == {roots[0].call}


def _count_loops(monkeypatch):
    """Wrap ``fixed_point_iterate`` and ``boruvka_forest`` wherever the
    port imported them, summing their returned steps and rounds."""
    seen = {"steps": 0, "rounds": 0}
    fpi, bf = grid_mod.fixed_point_iterate, parallel_merge.boruvka_forest

    def steps(*args, **kwargs):
        out = fpi(*args, **kwargs)
        seen["steps"] += out[1]
        return out

    def rounds(*args, **kwargs):
        out = bf(*args, **kwargs)
        seen["rounds"] += out[2]
        return out

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("repro_torch"):
            if getattr(mod, "fixed_point_iterate", None) is fpi:
                monkeypatch.setattr(mod, "fixed_point_iterate", steps)
            if getattr(mod, "boruvka_forest", None) is bf:
                monkeypatch.setattr(mod, "boruvka_forest", rounds)
    return seen


# Fixed sites on the host (uploads and input checks count only on the
# card): one overflow check for run and run_batch, four for run_tiled
# (the regrow test and the result's stats each read both flags); one
# live-root count per fused phase C or seam merge.
FIXED = {"run": 1 + 1, "run_tiled": 2 * (4 + 1), "run_batch": 2 * (1 + 2)}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_readbacks_are_the_loops_plus_the_fixed_sites(recorder,
                                                      monkeypatch, name):
    cfg, entry, _ = ENTRIES[name]
    eng = _engine(**cfg)
    entry(eng)
    seen = _count_loops(monkeypatch)
    recorder.reset()
    entry(eng)
    counters = recorder.snapshot()["counters"]
    assert set(k for k, _ in counters) == {"readbacks"}
    assert sum(counters.values()) == \
        seen["steps"] + seen["rounds"] + FIXED[name]
    assert seen["rounds"] > 0


def test_profiler_ranges_mirror_the_stage_spans(recorder, tmp_path):
    cfg, entry, _ = ENTRIES["run_tiled"]
    eng = _engine(**cfg)
    entry(eng)
    recorder.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        entry(eng)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = sorted(
        (e for e in json.loads(path.read_text())["traceEvents"]
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e["name"].startswith(telemetry.PROFILER_PREFIX)),
        key=lambda e: (float(e["ts"]), -float(e["dur"])))
    spans = recorder.snapshot()["spans"]
    stages = sorted((s for s in spans if not s.root),
                    key=lambda s: s.t0_ns)
    assert [e["name"] for e in ranges] == [
        telemetry.PROFILER_PREFIX + s.name for s in stages]
    assert not any(e["name"] == telemetry.PROFILER_PREFIX + "run_tiled"
                   for e in ranges)
    at = {s.id: e for s, e in zip(stages, ranges)}
    for s in stages:
        if s.parent in at:
            e, p = at[s.id], at[s.parent]
            assert float(p["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= \
                float(p["ts"]) + float(p["dur"])


def test_concurrent_spans_and_counts_lose_nothing(recorder):
    """More threads than cores, a short switch interval: every span and
    every count of every thread is kept, each thread's spans in a call
    of its own."""
    n_threads, n_iter = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with telemetry.call("job"):
            for _ in range(n_iter):
                with telemetry.span("step"):
                    telemetry.count("ticks")

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = recorder.snapshot()
    assert snap["counters"] == {("ticks", "step"): n_threads * n_iter}
    roots = {s.id for s in snap["spans"] if s.root}
    steps = [s for s in snap["spans"] if s.name == "step"]
    assert len(roots) == n_threads and len(steps) == n_threads * n_iter
    assert all(s.parent == s.call and s.call in roots for s in steps)


# -- run_delta: the frame store's spans and counters ------------------------

def _delta_engine():
    from repro_torch.ph import DeltaSpec
    return _engine(tile=TileSpec(grid=(4, 4)), delta=DeltaSpec())


def _dirtied(frame, tiles):
    """``frame`` with one pixel raised well inside each of ``tiles``
    (16² tiles of a 64² frame)."""
    out = frame.copy()
    for t in tiles:
        out[(t // 4) * 16 + 8, (t % 4) * 16 + 8] += 9.0
    return out


DELTA_KINDS = ("delta_full", "delta_partial", "delta_miss")


def test_delta_spans_and_counters_for_a_miss_a_partial_and_a_full_hit(
        recorder):
    base = _frames(1, 64)[0]
    changed = _dirtied(base, [5])
    eng = _delta_engine()
    hits = [eng.run_delta(x, 0.5).delta.hit for x in (base, changed,
                                                       changed)]
    assert hits == ["miss", "partial", "full"]
    snap = recorder.snapshot()
    spans = snap["spans"]
    by_id = {s.id: s for s in spans}
    roots = sorted((s for s in spans if s.root), key=lambda s: s.t0_ns)
    assert [r.name for r in roots] == ["run_delta"] * 3
    _check_calls(spans, 3, {"delta.hash", "delta.lookup"})

    def named(call):
        return sorted(s.name for s in spans if s.call == call.call
                      and s.name.startswith("delta."))

    worked = ["delta.hash", "delta.lookup", "delta.lookup",
              "delta.scatter", "delta.stage"]
    assert named(roots[0]) == named(roots[1]) == worked
    assert named(roots[2]) == ["delta.hash", "delta.lookup"]
    for s in spans:
        if s.name in ("delta.hash", "delta.lookup", "delta.stage"):
            assert by_id[s.parent].root
        elif s.name == "delta.scatter":     # inside the merge plan's call
            assert by_id[s.parent].name == "dispatch"
            assert s.events is None         # a CPU stage has no events
    counts = {}
    for (name, _), n in snap["counters"].items():
        counts[name] = counts.get(name, 0) + n
    assert {k: counts.get(k, 0) for k in DELTA_KINDS} == dict.fromkeys(
        DELTA_KINDS, 1)
    assert counts["delta_dirty_tiles"] == 16 + 1


def test_delta_dirty_tiles_leave_out_the_bucket_padding(recorder):
    base = _frames(1, 64)[0]
    eng = _delta_engine()
    eng.run_delta(base, 0.5)
    recorder.reset()
    res = eng.run_delta(_dirtied(base, [0, 6, 13]), 0.5)
    assert res.delta.hit == "partial" and res.delta.n_dirty == 3
    from repro_torch.core.delta import dirty_bucket
    assert dirty_bucket(3, 16) == 4
    counters = recorder.snapshot()["counters"]
    assert sum(n for (name, _), n in counters.items()
               if name == "delta_dirty_tiles") == 3


def test_delta_with_the_recorder_off_records_nothing(monkeypatch):
    telemetry.disable()
    telemetry.reset()

    def refuse(*args, **kwargs):
        raise AssertionError("made while the recorder is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    base = _frames(1, 64)[0]
    eng = _delta_engine()
    hits = [eng.run_delta(x, 0.5).delta.hit
            for x in (base, _dirtied(base, [2]), base)]
    assert hits == ["miss", "partial", "full"]
    assert telemetry.snapshot() == {"spans": [], "counters": {}}

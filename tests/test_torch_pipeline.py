"""Port parity: the distributed PH pipeline (repro_torch.pipeline,
repro_torch.distributed, PHEngine.run_distributed, the ph_run CLI).

The scheduler's output equals the reference's for the same inputs; the
port's ``run_distributed`` gives the reference's per-image summaries
bitwise (every field of the work log's record) — synchronous, with the
overlap engine, over a two-executor CPU context, with regrow, with a
failure and a work-log resume, and with delta-PH in the loop — and its
counters keep the overlap contract.  The port's ``part_lpt`` is held to
the bounds that hold for LPT.  Inputs are made from a seed with numpy.
"""
import contextlib
import io
import itertools
import json
import re
import sys

import numpy as np
import pytest

from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro.ph import TileSpec as JTileSpec
from repro.pipeline import scheduler as jsched
from repro_torch.distributed.context import (DistContext, auto_context,
                                             single_device_ctx)
from repro_torch.ph import DeltaSpec, OverlapSpec, PHConfig, PHEngine, \
    TileSpec
from repro_torch.pipeline import scheduler as tsched
from repro_torch.pipeline.driver import FailureInjector, run_pipeline
from repro_torch.pipeline.executor import ShardedPHExecutor

# The reference's heterogeneous mix (tests/test_overlap.py): 24² images pad
# into 32² buckets, the 64² frame exceeds the tile budget and runs tiled.
IMAGES = [(0, 24), (1, 32), (2, 64), (3, 32), (4, 24)]
TILE = dict(grid=(2, 2), max_features_per_tile=1024,
            max_candidates_per_tile=2048, max_tile_pixels=32 * 32)


def _cfg(pkg, **kw):
    """Config kwargs of the tiled pipeline engine for either package."""
    tile_cls = JTileSpec if pkg == "ref" else TileSpec
    kw.setdefault("max_features", 4096)
    kw.setdefault("filter_level", "filter_std")
    return dict(tile=tile_cls(**TILE), **kw)


def _port(**kw):
    return PHEngine(PHConfig(**_cfg("port", **kw)), device="cpu")


def _ref(**kw):
    return JEngine(JConfig(**_cfg("ref", **kw)))


@pytest.fixture(scope="module")
def want():
    """The reference's clean run of the mix (summaries per image)."""
    return _ref(prefetch_rounds=1).run_distributed(IMAGES)


def _whole_rounds(m: int) -> int:
    """Whole-image rounds the port schedules for IMAGES over m executors
    (every image at most one tile budget is whole; the 64² one is tiled)."""
    pool = ShardedPHExecutor(_port(), DistContext(("cpu",) * m))
    metas = tsched.normalize_images(IMAGES)
    sched = tsched.make_bucketed_schedule(
        "part_LPT", metas, m, pool.estimate_costs(metas), rounding="pow2",
        max_tile_pixels=TILE["max_tile_pixels"])
    return sum(r.kind == "whole" for r in sched.rounds())


# ---------------------------------------------------------------------------
# The scheduler: a copy, so its output equals the reference's
# ---------------------------------------------------------------------------

def _metas(mod, n, seed, sizes=(16, 24, 32, 48, 64, 100)):
    rng = np.random.default_rng(seed)
    return [mod.ImageMeta(i, (int(rng.choice(sizes)), int(rng.choice(sizes))))
            for i in range(n)]


def _costs(n, seed):
    rng = np.random.default_rng(seed + 1000)
    return {i: float(rng.pareto(1.5) + 0.1) for i in range(n)}


def _norm(obj):
    """Scheduler output of either package as plain tuples."""
    if hasattr(obj, "queues"):
        return (obj.strategy, obj.queues, obj.num_rounds)
    if hasattr(obj, "round_list"):
        return (obj.strategy, [
            (r.kind, r.shape, [(s, m.image_id, m.shape) for s, m in r.entries])
            for r in obj.round_list])
    if isinstance(obj, list):
        return [(m.image_id, m.shape) for m in obj]
    return obj


SCHEDULE_CASES = (
    [("make_schedule", s, n, m, seed)
     for s in ("part_executors", "part_images", "part_LPT")
     for n, m, seed in ((1, 1, 0), (7, 3, 1), (40, 8, 2), (13, 13, 3))]
    + [("make_bucketed_schedule", s, n, m, seed, kw)
       for s in ("part_executors", "part_images", "part_LPT")
       for n, m, seed, kw in (
           (9, 2, 4, dict()),
           (17, 4, 5, dict(rounding="exact")),
           (12, 3, 6, dict(pad=False)),
           (20, 4, 7, dict(max_tile_pixels=48 * 48)),
           (6, 1, 8, dict(max_tile_pixels=32 * 32, rounding="exact")))]
    + [("normalize_images", [3, (4, 20), (5, (16, 24)), "meta"], 512),
       ("normalize_images", list(range(6)), 64),
       ("assign_bucket", (5, 9), None, "pow2"),
       ("assign_bucket", (5, 9), None, "exact"),
       ("assign_bucket", (30, 17), ((16, 16), (32, 32), (64, 16)), "pow2"),
       ("assign_bucket", (70, 10), ((16, 16), (32, 32)), "pow2"),
       ("bucket_shape", (33, 64), "pow2"),
       ("bucket_shape", (33, 64), "exact")])


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=lambda c: c[0])
def test_scheduler_equals_reference(case):
    name, *args = case
    outs = []
    for mod in (jsched, tsched):
        if name == "make_schedule":
            s, n, m, seed = args
            out = mod.make_schedule(s, list(range(n)), m, _costs(n, seed),
                                    seed=seed)
            if s == "part_LPT":     # also the queue and lockstep makespans
                out = (_norm(out), out.makespan(_costs(n, seed)),
                       out.queue_makespan(_costs(n, seed)))
        elif name == "make_bucketed_schedule":
            s, n, m, seed, kw = args
            sched = mod.make_bucketed_schedule(s, _metas(mod, n, seed), m,
                                               _costs(n, seed), seed=seed,
                                               **kw)
            out = (_norm(sched), sched.makespan(_costs(n, seed)))
        elif name == "normalize_images":
            spec, size = args
            spec = [mod.ImageMeta(9, (8, 12)) if x == "meta" else x
                    for x in spec]
            out = mod.normalize_images(spec, default_size=size)
        else:
            out = getattr(mod, name)(*args)
        outs.append(_norm(out))
    assert outs[0] == outs[1]


def test_scheduler_rejects_what_the_reference_rejects():
    for mod in (jsched, tsched):
        with pytest.raises(ValueError):
            mod.make_schedule("part_LPT", [1, 2], 2, None)
        with pytest.raises(ValueError):
            mod.make_bucketed_schedule("part_LPT", [mod.ImageMeta(0, (8, 8))],
                                       2, None)
        with pytest.raises(ValueError):
            mod.normalize_images([1, 1])
        with pytest.raises(ValueError):
            mod.bucket_shape((4, 4), "odd")


# ---------------------------------------------------------------------------
# LPT: the bounds that do hold
# ---------------------------------------------------------------------------

def _opt_makespan(costs: np.ndarray, m: int) -> float:
    """Brute-force optimum of the asynchronous makespan (n <= 8)."""
    n = len(costs)
    assign = np.array(list(itertools.product(range(m), repeat=n)))
    loads = ((assign[:, :, None] == np.arange(m)) * costs[None, :, None]
             ).sum(axis=1)
    return float(loads.max(axis=1).min())


@pytest.mark.parametrize("seed", range(12))
def test_part_lpt_list_scheduling_and_graham_bounds(seed):
    """Two theorems about LPT: the list-scheduling bound against the
    lower bound (Σc/m + (1 − 1/m)·max c) and Graham's 4/3 − 1/(3m)
    bound against the optimum, which brute force finds for n <= 8."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 5))
    n = int(rng.integers(m + 1, 9))
    if seed % 2:
        c = rng.pareto(1.5, n) + 0.1           # stragglers
    else:
        c = rng.integers(1, 6, n).astype(float)   # ties
    costs = {i: float(c[i]) for i in range(n)}
    lpt = tsched.part_lpt(list(range(n)), m, costs).queue_makespan(costs)
    assert lpt <= sum(c) / m + (1 - 1 / m) * max(c) + 1e-9
    opt = _opt_makespan(c, m)
    assert opt - 1e-9 <= lpt <= (4 / 3 - 1 / (3 * m)) * opt + 1e-9


def test_lpt_counterexample_to_the_lower_bound_form():
    """n = m + 1 equal costs, m = 3: LPT's makespan is 2 and so is the
    optimum, but max(max c, Σc/m) is 4/3, so a 4/3 − 1/(3m) bound
    against that lower bound (1.22) fails while Graham's holds."""
    m, costs = 3, {i: 1.0 for i in range(4)}
    lpt = tsched.part_lpt(list(costs), m, costs).queue_makespan(costs)
    lower = max(max(costs.values()), sum(costs.values()) / m)
    assert lpt == 2.0 == _opt_makespan(np.ones(4), m)
    assert lpt > (4 / 3 - 1 / (3 * m)) * lower
    assert lpt <= (4 / 3 - 1 / (3 * m)) * 2.0


# ---------------------------------------------------------------------------
# Device contexts
# ---------------------------------------------------------------------------

def test_contexts_raise_without_cuda_unless_asked_for_the_cpu():
    import torch
    ctx = auto_context("cpu")
    assert ctx.dp_size == 1 and ctx.devices[0].type == "cpu"
    assert single_device_ctx("cpu") == ctx
    assert DistContext(("cpu", "cpu")).dp_size == 2
    with pytest.raises(ValueError):
        DistContext(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            auto_context()
        with pytest.raises(RuntimeError, match="CUDA"):
            single_device_ctx()
        with pytest.raises(RuntimeError, match="CUDA"):
            PHEngine(PHConfig()).run_distributed([0])


def test_tiled_run_rejects_a_context_on_another_device():
    eng = _port()
    img = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    other = DistContext(("meta",))
    with pytest.raises(ValueError, match="device"):
        eng.run_tiled(img, ctx=other)
    a = eng.run_tiled(img, ctx=auto_context("cpu"))
    b = eng.run_tiled(img)
    for f in a.diagram._fields:
        assert np.array_equal(getattr(a.diagram, f).numpy(),
                              getattr(b.diagram, f).numpy())


# ---------------------------------------------------------------------------
# run_distributed against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "overlap", "two_executors",
                                  "overlap_two_executors", "no_prefetch"])
def test_run_distributed_equals_reference(want, mode):
    overlap = OverlapSpec() if "overlap" in mode else None
    eng = _port(prefetch_rounds=0 if mode == "no_prefetch" else 1,
                overlap=overlap)
    m = 2 if "two" in mode else 1
    ctx = DistContext(("cpu",) * m)
    before = eng.overlap_counters.snapshot()
    got = eng.run_distributed(IMAGES, ctx=ctx)
    after = eng.overlap_counters.snapshot()
    assert got.diagrams == want.diagrams
    assert got.failures == 0 and len(got.diagrams) == len(IMAGES)
    whole = _whole_rounds(m)
    assert got.rounds == whole + 1      # plus the one tiled round
    assert after["h2d_transfers"] - before["h2d_transfers"] == whole
    if overlap is None:
        assert after["dispatch_syncs"] - before["dispatch_syncs"] \
            == got.rounds
        assert after["harvest_syncs"] == 0
    else:
        assert after["dispatch_syncs"] == before["dispatch_syncs"]
        assert after["harvest_syncs"] - before["harvest_syncs"] \
            == got.rounds


def test_two_executor_rounds_match_the_reference_schedule():
    """M = 2: the round count the reference's scheduler gives two
    executors, each round's batch split one row per device."""
    metas = jsched.normalize_images(IMAGES)
    pool = ShardedPHExecutor(_port(), DistContext(("cpu", "cpu")))
    costs = pool.estimate_costs(tsched.normalize_images(IMAGES))
    ref = jsched.make_bucketed_schedule(
        "part_LPT", metas, 2, costs, rounding="pow2",
        max_tile_pixels=TILE["max_tile_pixels"])
    got = run_pipeline(pool, IMAGES)
    assert got.rounds == ref.num_rounds < len(IMAGES)


def test_run_distributed_regrow_equals_reference():
    """A capacity too small for every image: rounds regrow (and stick),
    with the reference's summaries; regrow replays re-stage nothing."""
    imgs = [(i, 32) for i in range(4)]
    kw = dict(max_features=4, max_candidates=8, filter_level="filter_std")
    ref = JEngine(JConfig(**kw))
    want = ref.run_distributed(imgs)
    for overlap in (None, OverlapSpec()):
        eng = PHEngine(PHConfig(overlap=overlap, **kw), device="cpu")
        got = eng.run_distributed(imgs)
        assert got.diagrams == want.diagrams
        assert eng.regrow_log and \
            len(eng.regrow_log) == len(ref.regrow_log)
        assert eng.regrow_log[-1]["to"] == tuple(ref.regrow_log[-1]["to"])
        snap = eng.overlap_counters.snapshot()
        assert snap["h2d_transfers"] == len(imgs)


def test_failure_injection_and_resume_equal_reference(tmp_path, want):
    """Failures while later rounds are staged and in flight: completed
    harvests are recorded, unresolved rounds re-schedule, the result is
    the clean run's, the log holds one line per image, and a resume from
    the log computes nothing."""
    for k, overlap in enumerate((None, OverlapSpec(staging_depth=2))):
        log = tmp_path / f"work{k}.jsonl"
        eng = _port(prefetch_rounds=1, overlap=overlap)
        res = eng.run_distributed(IMAGES, work_log=log,
                                  failure_injector=FailureInjector([0, 1]))
        assert res.failures == 2
        assert res.diagrams == want.diagrams
        ids = [json.loads(line)["image_id"]
               for line in log.read_text().splitlines()]
        assert sorted(ids) == sorted(i for i, _ in IMAGES)
        again = _port(overlap=overlap)
        res2 = again.run_distributed(IMAGES, work_log=log)
        assert res2.diagrams == want.diagrams and res2.rounds == 0
        snap = again.overlap_counters.snapshot()
        assert snap["h2d_transfers"] == 0 and snap["harvest_syncs"] == 0


def test_failure_with_delta_in_the_loop_equals_reference(tmp_path):
    """The delta frame store stays consistent when an overlapped round
    fails mid-flight: retried rounds replace entries in place and the
    result equals the reference's delta-free, overlap-free run."""
    imgs = [(0, 32), (2, 64)]
    log = tmp_path / "delta.jsonl"
    eng = _port(delta=DeltaSpec(cache_entries=8), overlap=OverlapSpec(),
                prefetch_rounds=1)
    res = eng.run_distributed(imgs, work_log=log,
                              failure_injector=FailureInjector([0, 1]))
    assert res.failures == 2 and len(res.diagrams) == 2
    assert len(eng._delta_cache._entries) == 1     # one oversized frame
    assert res.diagrams == _ref().run_distributed(imgs).diagrams
    again = _port(delta=DeltaSpec(cache_entries=8), overlap=OverlapSpec())
    assert again.run_distributed(imgs, work_log=log).rounds == 0


def test_run_round_and_tiled_rounds_dedupe_rows():
    """The batch-shaped entry point: a whole round equals per-image runs,
    an oversized round runs each distinct row once."""
    eng = _port()
    pool = ShardedPHExecutor(eng, DistContext(("cpu", "cpu")))
    rng = np.random.default_rng(3)
    small = rng.normal(size=(2, 16, 16)).astype(np.float32)
    tv = np.full(2, -np.inf, np.float32)
    got = pool.run_round(small, tv)
    for i in range(2):
        one = eng.run(small[i], truncate_value=-np.inf).diagram
        for f in one._fields:
            assert np.array_equal(getattr(got, f)[i].numpy(),
                                  getattr(one, f).numpy()), f
    big = rng.normal(size=(1, 64, 64)).astype(np.float32)
    calls = []
    orig = pool._tiled
    pool._tiled = lambda im, t: calls.append(1) or orig(im, t)
    out = pool.run_round(np.concatenate([big, big]), np.zeros(2, np.float32))
    assert len(calls) == 1
    for f in out._fields:
        x = getattr(out, f).numpy()
        assert np.array_equal(x[0], x[1]), f


def test_executor_stages_one_group_per_round():
    """Building a round touches only the staging slot's host buffers;
    staging it is one upload group, after which each device's rows hold
    the host batch."""
    eng = _port()
    pool = ShardedPHExecutor(eng, DistContext(("cpu", "cpu")))
    rnd = tsched.BucketRound("whole", (32, 32),
                             ((0, tsched.ImageMeta(0, (24, 24))),))
    staged = pool._build_host_round(rnd)
    assert staged.fixups[0] is not None and staged.slot.uploaded == [None] * 2
    before = eng.overlap_counters.snapshot()["h2d_transfers"]
    staged = pool._stage_round(staged)
    assert eng.overlap_counters.snapshot()["h2d_transfers"] == before + 1
    rows, tvals = staged.slot.ready()
    import torch
    assert torch.equal(torch.cat(rows), staged.slot.host_batch)
    assert torch.equal(torch.cat(tvals), staged.slot.host_tvals)
    # the free slot repeats the staged image
    assert torch.equal(rows[0], rows[1])


# ---------------------------------------------------------------------------
# The ph_run CLI
# ---------------------------------------------------------------------------

def _cli(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ph_run", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main()
    text = buf.getvalue()
    return json.loads(text[re.search(r"^\{", text, re.M).start():])


def test_ph_run_cli_prints_the_reference_block(monkeypatch, tmp_path):
    from repro.launch import ph_run as jrun
    from repro_torch.launch import ph_run as trun
    args = ["--images", "4", "--size", "64"]
    want_block = _cli(jrun.main, args, monkeypatch)
    got = _cli(trun.main, ["--device", "cpu", *args], monkeypatch)
    assert set(got) == set(want_block)
    for key in ("config", "images", "rounds", "failures_recovered",
                "total_objects", "mean_objects_per_image"):
        assert got[key] == want_block[key], key
    assert got["plan_cache"]["regrows"] == want_block["plan_cache"]["regrows"]
    # Overlap, a failure and a resume from the work log.
    log = str(tmp_path / "cli.jsonl")
    over = _cli(trun.main, ["--device", "cpu", *args, "--overlap",
                            "--inject-failure", "1", "--work-log", log],
                monkeypatch)
    assert over["failures_recovered"] == 1
    assert over["total_objects"] == want_block["total_objects"]
    assert over["overlap"]["dispatch_syncs"] == 0
    assert over["overlap"]["harvest_syncs"] > 0
    resumed = _cli(trun.main, ["--device", "cpu", *args, "--work-log", log],
                   monkeypatch)
    assert resumed["rounds"] == 0
    assert resumed["total_objects"] == want_block["total_objects"]

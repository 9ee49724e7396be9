"""Port parity: the overlap engine (repro_torch.ph.overlap,
``PHEngine.run_batch_async``, streamed tiled/delta results,
``PHConfig.from_flags``).

Every overlapped path resolves to the synchronous path's bytes: the
port's ``run_batch_async(...).resolve()`` equals the reference's
``run_batch`` (uniform, mixed-shape, deduplicated, regrowing with the
same attempts and capacities), streamed ``run_tiled``/``run_delta``
equal the reference's, the staging pool never hands out a caller's
memory, and ``from_flags`` builds the reference's config from the same
flags.  Tolerance: none — diagram fields compare bitwise.  Inputs are
made from a seed with numpy.  (CPU tensors take no pinned copies; the
card-only tests in ``tests/test_torch_cuda.py`` hold the pinned paths.)
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import assert_same_diagram
from repro.data import astro as jastro
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro.ph import DeltaSpec as JDeltaSpec
from repro.ph import TileSpec as JTileSpec
from repro_torch.core.pixhomology import Diagram
from repro_torch.data.astro import FrameSequence
from repro_torch.ph import DeltaSpec, OverlapSpec, PHConfig, PHEngine, \
    TileSpec
from repro_torch.ph.overlap import (OverlapCounters, PendingResult,
                                    StagingPool, map_tensors, start_d2h)


def _bumpy(seed=0, shape=(8, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _engine(**kw):
    return PHEngine(PHConfig(**kw), device="cpu")


def _stats(regrow) -> tuple:
    return (regrow.attempts, regrow.final_max_features,
            regrow.final_max_candidates, regrow.overflow)


_REF: dict = {}


def _reference(key, make_engine, imgs):
    """The reference's ``run_batch`` of one input, computed once per
    module (its compiles dominate this file's time)."""
    if key not in _REF:
        _REF[key] = make_engine().run_batch(imgs)
    return _REF[key]


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------

def test_pending_result_resolves_once_across_threads():
    calls = []

    def finish():
        calls.append(1)
        return {"value": len(calls)}

    pending = PendingResult(finish)
    out = []
    threads = [threading.Thread(target=lambda: out.append(pending.resolve()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert calls == [1] and all(o is out[0] for o in out)

    def boom():
        raise RuntimeError("deferred failure")

    bad = PendingResult(boom)
    for _ in range(2):          # the exception is re-raised every time
        with pytest.raises(RuntimeError, match="deferred"):
            bad.resolve()


def test_overlap_counters_are_thread_safe():
    c = OverlapCounters()
    threads = [threading.Thread(
        target=lambda: [c.bump("harvest_syncs") for _ in range(1000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert c.snapshot()["harvest_syncs"] == 8000
    assert set(c.snapshot()) == set(OverlapCounters.FIELDS)
    with pytest.raises(ValueError):
        c.bump("bogus")


def test_start_d2h_passes_host_trees_through():
    """Host tensors need no copy: the tree comes back as it is and no D2H
    group is counted."""
    d = Diagram(*(torch.arange(4) for _ in range(7)))
    tree = {"a": [d, (torch.ones(2), 3)], "b": "text"}
    c = OverlapCounters()
    got = start_d2h(tree, c).result()
    assert got["a"][0] is not d and all(
        x is y for x, y in zip(got["a"][0], d))
    assert got["a"][1][1] == 3 and got["b"] == "text"
    assert c.snapshot()["d2h_streams"] == 0
    doubled = map_tensors(lambda t: t * 2, tree)
    assert isinstance(doubled["a"][0], Diagram)
    assert torch.equal(doubled["a"][1][0], torch.full((2,), 2.0))


def test_staging_pool_reuses_only_released_slots():
    cpu = (torch.device("cpu"),)
    pool = StagingPool(reuse=True)
    a = pool.acquire(cpu, (2, 4, 4), torch.float32, torch.float32)
    b = pool.acquire(cpu, (2, 4, 4), torch.float32, torch.float32)
    assert a is not b                       # a is still in use
    pool.release(a)
    assert pool.acquire(cpu, (2, 4, 4), torch.float32, torch.float32) is a
    assert pool.acquire(cpu, (2, 4, 5), torch.float32, torch.float32) \
        is not b                            # another shape, another slot
    fresh = StagingPool(reuse=False)
    s = fresh.acquire(cpu, (1, 3, 3), torch.uint8, torch.float32)
    fresh.release(s)
    assert fresh.acquire(cpu, (1, 3, 3), torch.uint8, torch.float32) is not s
    # On the CPU a device's rows are views of the host batch.
    two = pool.acquire(cpu * 2, (2, 3, 3), torch.int16, torch.float32)
    two.host_batch.copy_(torch.arange(18).reshape(2, 3, 3))
    rows, _ = pool.upload(two).ready()
    assert torch.equal(torch.cat(rows), two.host_batch)
    with pytest.raises(ValueError):
        pool.acquire(cpu * 2, (3, 3, 3), torch.int16, torch.float32)


# ---------------------------------------------------------------------------
# from_flags builds the reference's config
# ---------------------------------------------------------------------------

FLAG_CASES = [
    dict(),
    dict(overlap=True, overlap_depth=3, no_donate=True),
    dict(no_async_harvest=True),
    dict(no_async_overflow=True, no_prefetch=True),
    dict(filter="filter_heavy", merge_impl="boruvka", max_features=64,
         max_candidates=128, no_regrow=True, candidate_mode="paper",
         phase_a_impl="pooled", strip_rows=4, bucket_rounding="exact"),
    dict(tile_grid="2x4", tile_max_features=32, max_tile_pixels=1024),
    dict(tile=True, delta=True, delta_cache_entries=3, delta_hash="sha1",
         delta_verify=True),
    dict(serve_buckets=["64", "32x48"], serve_batch_cap=3,
         serve_tick_ms=5, serve_admission="block"),
    dict(filtration="sublevel", dtype="float32", merge_keys="rank",
         phase_c_impl="xla", tournament_width=3, regrow_factor=4,
         max_regrows=2, prefetch_rounds=3),
]


@pytest.mark.parametrize("flags", FLAG_CASES)
def test_from_flags_equals_reference(flags):
    ns = SimpleNamespace(**flags)
    got = PHConfig.from_flags(ns)
    want = JConfig.from_flags(ns)
    assert got.to_json() == want.to_json()
    assert PHConfig.from_flags(ns, max_features=7).max_features == 7


# ---------------------------------------------------------------------------
# run_batch_async == the reference's run_batch
# ---------------------------------------------------------------------------

BATCHES = {
    "uniform": lambda: np.stack([_bumpy(0), _bumpy(1), _bumpy(2)]),
    "mixed": lambda: [_bumpy(3, (6, 5)), _bumpy(4, (8, 8)),
                      _bumpy(5, (5, 9))],
    "duplicates": lambda: [_bumpy(6, (7, 7)), _bumpy(7, (8, 8)),
                           _bumpy(6, (7, 7))],
}


@pytest.mark.parametrize("overlap", [None, OverlapSpec(),
                                     OverlapSpec(donate=False),
                                     OverlapSpec(async_overflow=False)],
                         ids=["sync", "overlap", "no_donate",
                              "no_async_overflow"])
@pytest.mark.parametrize("kind", sorted(BATCHES))
def test_run_batch_async_equals_reference_run_batch(kind, overlap):
    imgs = BATCHES[kind]()
    kw = dict(filter_level="filter_std", merge_impl="boruvka")
    want = _reference(kind, lambda: JEngine(JConfig(**kw)), imgs)
    eng = _engine(overlap=overlap, **kw)
    pending = eng.run_batch_async(imgs)
    got = pending.resolve()
    assert pending.resolve() is got            # memoized
    assert_same_diagram(want.diagram, got.diagram, kind)
    assert _stats(got.regrow) == _stats(want.regrow)
    np.testing.assert_array_equal(np.asarray(got.threshold, np.float64),
                                  np.asarray(want.threshold, np.float64))
    assert_same_diagram(want.diagram, eng.run_batch(imgs).diagram,
                        f"{kind} again")


@pytest.mark.parametrize("overlap", [None, OverlapSpec()],
                         ids=["sync", "overlap"])
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_regrowing_batch_matches_reference_attempts(overlap, mixed):
    """A batch that overflows at max_features=4 regrows to the reference's
    capacities in the reference's number of attempts; with the overlap on
    the check runs at resolve()."""
    imgs = [_bumpy(11, (16, 16)), _bumpy(12, (16, 13) if mixed
                                          else (16, 16))]
    if not mixed:
        imgs = np.stack(imgs)
    kw = dict(max_features=4, max_candidates=16)
    want = _reference(("regrow", mixed), lambda: JEngine(JConfig(**kw)),
                      imgs)
    eng = _engine(overlap=overlap, **kw)
    pending = eng.run_batch_async(imgs)
    if overlap is not None:
        assert not eng.regrow_log       # nothing dispatched yet
    got = pending.resolve()
    assert want.regrow.regrown and _stats(got.regrow) == _stats(want.regrow)
    assert got.config.max_features == want.config.max_features
    assert_same_diagram(want.diagram, got.diagram)
    snap = eng.overlap_counters.snapshot()
    assert snap["dispatch_syncs"] == 0


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_buffer_reuse_leaves_caller_arrays_intact(as_tensor):
    """The staging pool only ever holds engine-built copies: the caller's
    arrays (numpy or tensors, uniform or mixed) are untouched across
    repeated calls that reuse pool slots, and each repeat gives the same
    bytes."""
    eng = _engine(overlap=OverlapSpec(), filter_level="filter_std")
    uniform = np.stack([_bumpy(20, (9, 9)), _bumpy(21, (9, 9))])
    mixed = [_bumpy(22, (6, 6)), _bumpy(23, (8, 8))]
    if as_tensor:
        uniform = torch.from_numpy(uniform)
        mixed = [torch.from_numpy(m) for m in mixed]
    copies = ([uniform.clone() if as_tensor else uniform.copy()],
              [m.clone() if as_tensor else m.copy() for m in mixed])
    first = [eng.run_batch(uniform), eng.run_batch(mixed)]
    for _ in range(2):
        again = [eng.run_batch(uniform), eng.run_batch(mixed)]
        for a, b in zip(first, again):
            assert_same_diagram(a.diagram, b.diagram)
    for got, want in zip([uniform, *mixed], [*copies[0], *copies[1]]):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    # Pool slots came back to the pool and were handed out again (a
    # tensor already on the engine's device is used as it is, unstaged).
    idle = sum(len(v) for v in eng.staging._idle.values())
    assert idle == (1 if as_tensor else 2)


# ---------------------------------------------------------------------------
# Streamed tiled and delta results
# ---------------------------------------------------------------------------

def test_streamed_run_tiled_and_run_delta_equal_reference():
    fs = FrameSequence(3, 32, grid=(2, 2), dirty_frac=0.3, stamp=3)
    tv, _ = jastro.filter_threshold(fs.base(), "filter_std")

    def tile(cls):
        return cls(grid=(2, 2), max_tile_pixels=16 * 16,
                   max_features_per_tile=256, max_candidates_per_tile=512)

    ref = JEngine(JConfig(max_features=2048, tile=tile(JTileSpec),
                          delta=JDeltaSpec(cache_entries=4)))
    sync = _engine(max_features=2048, tile=tile(TileSpec),
                   delta=DeltaSpec(cache_entries=4))
    over = _engine(max_features=2048, tile=tile(TileSpec),
                   delta=DeltaSpec(cache_entries=4), overlap=OverlapSpec())
    for i in range(3):
        frame = fs.frame(i)
        want = ref.run_delta(frame, tv)
        for eng in (sync, over):
            got = eng.run_delta(frame, tv)
            assert got.delta.hit == want.delta.hit
            assert_same_diagram(want.diagram, got.diagram, f"delta {i}")
        assert_same_diagram(ref.run_tiled(frame, tv).diagram,
                            over.run_tiled(frame, tv).diagram, f"tiled {i}")

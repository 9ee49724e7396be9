"""Port parity: PH-as-a-service (repro_torch.serving, ``PHEngine.warmup``,
``launch/ph_serve.py``) against the reference package.

Every test of ``tests/test_serving.py``, the cache-tier tests of
``tests/test_delta.py`` and the server tests of ``tests/test_overlap.py``
run here against the port's daemon on the host (``device="cpu"``: the
kernels' plain versions), and each served diagram is held to the
reference's (``PHEngine.run``, the tiled path or the reference's own
``PHServer``) on the same seeded numpy inputs.  ``warmup`` builds the
reference's plan counts and ends on its regrow capacities, and the SLO
metrics give the reference's numbers on the same samples.  Tolerance:
none — diagrams compare bitwise on ``to_array()`` plus the unmerged count
and the overflow flag, every counter exactly.

One warmed module-scoped engine backs most tests; per-test servers
override only host-side knobs (max_queue / tick / admission), which never
enter plan_key, so the warmed plans are reused throughout.
"""
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tiling as jtiling
from repro.ph import PHConfig as JConfig
from repro.ph import PHEngine as JEngine
from repro.ph import ServeSpec as JServeSpec
from repro.pipeline.scheduler import assign_bucket as jassign_bucket
from repro.serving import PHServer as JServer
from repro.serving import Reservoir as JReservoir
from repro.serving import ServeMetrics as JServeMetrics
from repro_torch.launch import ph_serve
from repro_torch.ph import (DeltaSpec, FilterLevel, OverlapSpec, PHConfig,
                            PHEngine, ServeSpec, TileSpec)
from repro_torch.ph.overlap import PendingResult
from repro_torch.pipeline.scheduler import assign_bucket
from repro_torch.serving import (
    AdmissionError,
    PHServer,
    Reservoir,
    ServeMetrics,
    bucket_label,
)

BUCKETS = ((8, 8), (16, 16))
CAP = 3
SPEC = ServeSpec(buckets=BUCKETS, batch_cap=CAP, tick_interval_s=0.001)


def _bumpy(seed=0, shape=(8, 8)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mixed_images(seed=0, n=6):
    shapes = [(6, 5), (8, 8), (12, 10), (16, 16), (5, 9), (9, 14)]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shapes[i % len(shapes)]).astype(np.float32)
            for i in range(n)]


def _engine(**kw):
    return PHEngine(PHConfig(**kw), device="cpu")


def _fields(res) -> list:
    """A PHResult's or Diagram's fields (either package) as numpy."""
    d = getattr(res, "diagram", res)
    return [f.numpy() if isinstance(f, torch.Tensor) else np.asarray(f)
            for f in d]


def _same(want, got, what=""):
    """Two diagrams or results (either package) with bitwise-equal valid
    rows (``to_array()``), the same unmerged count and overflow flag
    (capacity padding may differ)."""
    w, g = _fields(want), _fields(got)
    count = int(w[4])
    assert int(g[4]) == count, f"{what} count"
    for i, name in enumerate(("birth", "death", "p_birth", "p_death")):
        assert w[i].dtype == g[i].dtype, f"{what} {name} dtype"
        assert np.array_equal(w[i][:count], g[i][:count]), f"{what} {name}"
    assert np.array_equal(w[5], g[5]), f"{what} n_unmerged"
    assert np.array_equal(w[6], g[6]), f"{what} overflow"


def _host_rows(res):
    return all(isinstance(f, torch.Tensor) and f.device.type == "cpu"
               for f in res.diagram)


_JRUN: dict = {}


def _reference_run(img, threshold):
    """The reference's ``run`` of ``img`` at ``threshold`` on one shared
    engine (each shape compiles once for the whole module)."""
    if "engine" not in _JRUN:
        _JRUN["engine"] = JEngine(JConfig())
    return _JRUN["engine"].run(img, truncate_value=threshold)


def _held_to_reference(imgs, results):
    for i, (im, res) in enumerate(zip(imgs, results)):
        assert _host_rows(res), i
        _same(_reference_run(im, res.threshold), res, f"request {i}")


@pytest.fixture(scope="module")
def engine():
    eng = _engine(serve=SPEC)
    info = eng.warmup()
    assert info["plans"] == info["traces"] == 2 * len(BUCKETS)
    return eng


# ---------------------------------------------------------------------------
# Lifecycle: submit -> coalesce -> compute -> future resolution
# ---------------------------------------------------------------------------

def test_submit_to_future_bit_identity(engine):
    imgs = _mixed_images(seed=1, n=8)
    with PHServer(engine) as srv:
        futs = [srv.submit(im) for im in imgs]
        results = [f.result(timeout=120) for f in futs]
    _held_to_reference(imgs, results)
    # The port's own run on a separate engine (the shared plan cache stays
    # untouched for the zero-build test).
    own = _engine()
    for im, res in zip(imgs, results):
        _same(own.run(im, truncate_value=res.threshold), res)


def test_warmed_server_zero_steady_state_traces(engine):
    with PHServer(engine) as srv:
        srv.warmup()        # plans cached -> instant; snapshots builds
        assert srv.steady_state_traces() == 0
        regrows = len(engine.regrow_log)
        imgs = _mixed_images(seed=2, n=12)
        futs = [srv.submit(im) for im in imgs]
        results = [f.result(timeout=120) for f in futs]
        assert srv.steady_state_traces() == 0
        assert len(engine.regrow_log) == regrows
        st = srv.stats()
    assert st["completed"] == 12
    assert st["failed"] == st["rejected"] == 0
    for b in st["buckets"].values():
        if b["batches"]:
            assert 0 < b["occupancy"] <= 1
            assert b["e2e_s"]["p50"] <= b["e2e_s"]["p99"]
    _held_to_reference(imgs, results)


def test_unstarted_server_queues_then_dispatches(engine):
    srv = PHServer(engine, start=False)
    imgs = [_bumpy(i) for i in range(4)]
    futs = [srv.submit(im) for im in imgs]
    time.sleep(0.05)
    assert not any(f.done() for f in futs)
    srv.start()
    results = [f.result(timeout=120) for f in futs]
    srv.shutdown()
    assert all(int(r.diagram.count) >= 0 for r in results)
    _held_to_reference(imgs, results)


# ---------------------------------------------------------------------------
# Admission control and backpressure
# ---------------------------------------------------------------------------

def test_backpressure_reject_at_full_queue(engine):
    srv = PHServer(engine, start=False, spec=SPEC.replace(max_queue=2))
    f1, f2 = srv.submit(_bumpy(0)), srv.submit(_bumpy(1))
    with pytest.raises(AdmissionError) as ei:
        srv.submit(_bumpy(2))
    assert ei.value.retry_after_s > 0
    srv.start()     # accepted requests still resolve
    r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    st = srv.stats()
    srv.shutdown()
    assert st["rejected"] == 1
    assert st["buckets"][bucket_label(BUCKETS[0])]["rejected"] == 1
    assert st["completed"] == 2
    _held_to_reference([_bumpy(0), _bumpy(1)], [r1, r2])


def test_backpressure_block_until_space(engine):
    srv = PHServer(engine, start=False,
                   spec=SPEC.replace(max_queue=1, admission="block"))
    f1 = srv.submit(_bumpy(0))
    unblocked = []

    def blocked_submit():
        unblocked.append(srv.submit(_bumpy(1)))

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    time.sleep(0.1)
    assert t.is_alive() and not unblocked     # parked at admission
    srv.start()                               # tick frees the slot
    t.join(timeout=120)
    assert not t.is_alive()
    results = [f1.result(timeout=120), unblocked[0].result(timeout=120)]
    srv.shutdown()
    _held_to_reference([_bumpy(0), _bumpy(1)], results)


def test_blocked_submitter_released_by_shutdown(engine):
    srv = PHServer(engine, start=False,
                   spec=SPEC.replace(max_queue=1, admission="block"))
    srv.submit(_bumpy(0))
    errs = []

    def blocked_submit():
        try:
            srv.submit(_bumpy(1))
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    time.sleep(0.05)
    srv.shutdown(drain=False)
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(errs) == 1 and not isinstance(errs[0], AdmissionError)


def test_submit_validation(engine):
    with PHServer(engine, start=False) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((2, 3, 4), np.float32))   # not 2D
        with pytest.raises(ValueError):
            srv.submit(np.zeros((17, 17), np.float32))    # over top bucket
        with pytest.raises(ValueError):
            srv.submit(torch.zeros((2, 3, 4)))            # tensors too
    with pytest.raises(RuntimeError):
        srv.submit(_bumpy())                              # shut down
    with pytest.raises(RuntimeError):
        srv.start()                                       # cannot restart


def test_submit_accepts_tensors_and_numpy_alike(engine):
    """A tensor request serves what its numpy twin serves; the daemon
    keeps a host copy of it."""
    img = _bumpy(7, (12, 10))
    with PHServer(engine) as srv:
        a = srv.submit(img).result(timeout=120)
        b = srv.submit(torch.from_numpy(img.copy())).result(timeout=120)
    _same(a, b)
    assert a.threshold == b.threshold
    _held_to_reference([img], [b])


# ---------------------------------------------------------------------------
# Graceful drain and shutdown
# ---------------------------------------------------------------------------

def test_graceful_drain_delivers_all_inflight(engine):
    srv = PHServer(engine, start=False)
    imgs = _mixed_images(seed=3, n=7)
    futs = [srv.submit(im) for im in imgs]
    srv.start()
    srv.shutdown(drain=True)        # stops admission, finishes the queue
    assert all(f.done() for f in futs)
    assert all(f.exception() is None for f in futs)
    _held_to_reference(imgs, [f.result() for f in futs])


def test_shutdown_without_drain_fails_pending(engine):
    srv = PHServer(engine, start=False)
    futs = [srv.submit(_bumpy(i)) for i in range(3)]
    srv.shutdown(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=5)


# ---------------------------------------------------------------------------
# Fault injection: one round's failure stays in that round
# ---------------------------------------------------------------------------

def test_fault_injected_round_isolated(engine, monkeypatch):
    # The tick thread dispatches through run_batch_async, so inject the
    # failure there.
    real = engine.run_batch_async
    fails = {"left": 1}

    def flaky(*a, **kw):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("injected dispatch failure")
        return real(*a, **kw)

    monkeypatch.setattr(engine, "run_batch_async", flaky)
    srv = PHServer(engine, start=False)
    # 2*CAP same-bucket requests -> exactly two dispatch rounds, FIFO.
    imgs = [_bumpy(i) for i in range(2 * CAP)]
    futs = [srv.submit(im) for im in imgs]
    srv.start()
    assert srv.drain(120)
    for f in futs[:CAP]:        # first round: the injected failure
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=5)
    good = [f.result(timeout=120) for f in futs[CAP:]]   # second: unharmed
    # the daemon survives: a fresh submit still resolves
    late = srv.submit(_bumpy(99)).result(timeout=120)
    st = srv.stats()
    srv.shutdown()
    assert st["failed"] == CAP
    assert st["completed"] == CAP + 1
    _held_to_reference(imgs[CAP:] + [_bumpy(99)], good + [late])


def test_failure_inside_resolve_isolated():
    """A raise in the deferred half (the harvest thread's ``resolve``)
    fails that round's futures only."""
    eng = _engine(serve=SPEC, overlap=OverlapSpec())
    real = eng.run_batch_async
    fails = {"left": 1}

    def boom():
        raise RuntimeError("injected resolve failure")

    def flaky(*a, **kw):
        pending = real(*a, **kw)
        if fails["left"]:
            fails["left"] -= 1
            return PendingResult(boom)
        return pending

    eng.run_batch_async = flaky
    srv = PHServer(eng, start=False)
    imgs = [_bumpy(i) for i in range(2 * CAP)]
    futs = [srv.submit(im) for im in imgs]
    srv.start()
    assert srv.drain(120)
    for f in futs[:CAP]:
        with pytest.raises(RuntimeError, match="injected resolve"):
            f.result(timeout=5)
    good = [f.result(timeout=120) for f in futs[CAP:]]
    st = srv.stats()
    srv.shutdown()
    assert st["failed"] == CAP and st["completed"] == CAP
    _held_to_reference(imgs[CAP:], good)


# ---------------------------------------------------------------------------
# Thread-safe shared engine
# ---------------------------------------------------------------------------

def test_engine_hammered_from_threads_traces_once():
    eng = _engine()
    img = np.stack([_bumpy(0), _bumpy(1)])
    barrier = threading.Barrier(8)
    errs, outs = [], []

    def hammer():
        try:
            barrier.wait(timeout=30)
            outs.append(eng.run_batch(img))
        except Exception as e:      # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs
    st = eng.plan_stats()
    # 8 racing cache misses -> one plan, built exactly once.
    assert st["plans"] == 1 and st["traces"] == 1 and st["calls"] == 8
    want = JEngine(JConfig()).run_batch(img).diagram
    for out in outs:
        for name, a, b in zip(want._fields, want, out.diagram):
            assert np.array_equal(np.asarray(a), b.numpy()), name


# ---------------------------------------------------------------------------
# Mixed-shape run_batch (bucketed padding bit-identity)
# ---------------------------------------------------------------------------

def _row(res, i):
    from repro_torch.core import Diagram
    from repro_torch.ph import PHResult
    tv = None
    if res.threshold is not None and np.isfinite(res.threshold[i]):
        tv = float(res.threshold[i])
    return PHResult(Diagram(*(f[i] for f in res.diagram)), res.config,
                    res.regrow, tv)


@pytest.mark.parametrize("level", [FilterLevel.VANILLA, FilterLevel.STD])
def test_run_batch_mixed_shapes_bit_identical(level):
    eng = _engine(filter_level=level)
    imgs = [_bumpy(0, (6, 5)), _bumpy(1, (8, 8)), _bumpy(2, (5, 9))]
    out = eng.run_batch(imgs)
    for i, im in enumerate(imgs):
        row = _row(out, i)
        _same(eng.run(im, truncate_value=row.threshold), row, f"row {i}")
        _same(_reference_run(im, row.threshold), row, f"reference {i}")


def test_run_batch_bucket_forces_padded_dispatch():
    eng = _engine()
    imgs = [_bumpy(0, (6, 6)), _bumpy(1, (6, 6))]
    out = eng.run_batch(imgs, bucket=(8, 8))
    ref = eng.run_batch(np.stack(imgs))
    jref = JEngine(JConfig()).run_batch(imgs, bucket=(8, 8))
    for i in range(2):
        row = _row(out, i)
        _same(_row(ref, i), row, f"row {i}")
        _same([np.asarray(f)[i] for f in jref.diagram], row,
               f"reference row {i}")
    assert np.array_equal(np.asarray(jref.threshold), out.threshold)


# ---------------------------------------------------------------------------
# ServeSpec config plumbing
# ---------------------------------------------------------------------------

def test_serve_spec_validation():
    assert ServeSpec(buckets=(32, (8, 16))).buckets == ((8, 16), (32, 32))
    assert ServeSpec(buckets=(32, (8, 16))).buckets == \
        JServeSpec(buckets=(32, (8, 16))).buckets
    for kw in (dict(buckets=(16, (16, 16))), dict(batch_cap=0),
               dict(max_queue=0), dict(tick_interval_s=-1.0),
               dict(admission="maybe")):
        with pytest.raises(ValueError):
            ServeSpec(**kw)
        with pytest.raises(ValueError):
            JServeSpec(**kw)


def test_serve_config_roundtrip_and_plan_key():
    cfg = PHConfig(serve=ServeSpec(buckets=(16, 32), batch_cap=2))
    again = PHConfig.from_json(cfg.to_json())
    assert again == cfg and again.plan_key() == cfg.plan_key()
    # host-side knobs stay out of plan_key; shape knobs go in
    assert cfg.plan_key() == PHConfig(serve=ServeSpec(
        buckets=(16, 32), batch_cap=2, max_queue=7,
        admission="block")).plan_key()
    assert cfg.plan_key() != PHConfig(serve=ServeSpec(
        buckets=(16, 32), batch_cap=3)).plan_key()
    assert PHConfig().plan_key()[-1] is None
    jcfg = JConfig.from_json(cfg.to_json())
    assert jcfg.serve.buckets == cfg.serve.buckets
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())


def test_serve_from_flags():
    flags = SimpleNamespace(
        serve=True, serve_buckets=["16", "32x48"], serve_batch_cap=8,
        serve_tick_ms=5.0, serve_admission="block", serve_max_queue=9)
    cfg = PHConfig.from_flags(flags)
    assert cfg.serve.buckets == ((16, 16), (32, 48))
    assert cfg.serve.batch_cap == 8 and cfg.serve.max_queue == 9
    assert abs(cfg.serve.tick_interval_s - 0.005) < 1e-12
    assert cfg.serve.admission == "block"
    assert PHConfig.from_flags(SimpleNamespace()).serve is None
    assert json.loads(cfg.to_json()) == \
        json.loads(JConfig.from_flags(flags).to_json())


def test_assign_bucket():
    bs = ((16, 16), (32, 32))
    assert assign_bucket((5, 5), bs) == (16, 16)      # tightest fit
    assert assign_bucket((16, 16), bs) == (16, 16)    # exact fit
    assert assign_bucket((17, 4), bs) == (32, 32)
    assert assign_bucket((33, 1), bs) is None         # over the top
    assert assign_bucket((40, 40), None) == (64, 64)  # dynamic pow2
    for shape in ((1, 1), (5, 5), (16, 16), (17, 4), (4, 17), (32, 32),
                  (33, 1), (40, 40), (3, 100)):
        for buckets in (bs, None, ((8, 64), (64, 8))):
            assert assign_bucket(shape, buckets) == \
                jassign_bucket(shape, buckets), (shape, buckets)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_reservoir_window_and_percentiles():
    r = Reservoir(4)
    # empty reservoirs summarize as zeros (scrapers need stable fields)
    assert r.summary() == {"count": 0, "mean": 0.0, "max": 0.0,
                           "p50": 0.0, "p95": 0.0, "p99": 0.0}
    assert r.percentile(50) == 0.0
    for v in range(1, 11):
        r.add(float(v))
    assert len(r) == 10
    s = r.summary()
    assert s["count"] == 10 and s["max"] == 10.0
    # only the ring window (last 4 values: 7..10) backs percentiles
    assert 7.0 <= s["p50"] <= 10.0 and r.percentile(0) == 7.0
    with pytest.raises(ValueError):
        Reservoir(0)


def test_serve_metrics_snapshot():
    m = ServeMetrics(batch_cap=4)
    b = (16, 16)
    m.record_submit(b)
    m.record_submit(b)
    m.record_batch(b, queue_waits=[0.1, 0.2], e2e=[0.3, 0.4], batch_s=0.2)
    m.record_reject(b)
    snap = m.snapshot()
    assert snap["submitted"] == 2 and snap["completed"] == 2
    assert snap["rejected"] == 1
    bs = snap["buckets"]["16x16"]
    assert bs["occupancy"] == 0.5       # 2 rows of a 4-cap batch
    assert bs["e2e_s"]["count"] == 2 and bs["rejected"] == 1
    assert bucket_label((8, 128)) == "8x128"


@pytest.mark.parametrize("capacity", [1, 5, 64])
def test_reservoir_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    samples = rng.exponential(size=97).tolist()
    mine, ref = Reservoir(capacity), JReservoir(capacity)
    for i, v in enumerate(samples):
        mine.add(v)
        ref.add(v)
        if i % 13 == 0:
            assert mine.summary() == ref.summary()
            for q in (0, 37.5, 50, 95, 99, 100):
                assert mine.percentile(q) == ref.percentile(q)
    mine.extend(samples[:7])
    ref.extend(samples[:7])
    assert mine.summary() == ref.summary() and len(mine) == len(ref)


def test_serve_metrics_match_reference():
    rng = np.random.default_rng(5)
    mine, ref = ServeMetrics(batch_cap=3, window=8), \
        JServeMetrics(batch_cap=3, window=8)
    buckets = [(8, 8), (16, 16), (8, 32)]
    for step in range(60):
        b = buckets[int(rng.integers(len(buckets)))]
        kind = int(rng.integers(6))
        for m in (mine, ref):
            if kind == 0:
                m.record_submit(b)
            elif kind == 1:
                m.record_reject(b)
            elif kind == 2:
                m.record_cache(hit=bool(step % 2))
            elif kind == 3:
                m.record_failure(b, 1 + step % 3)
        if kind >= 4:
            n = 1 + step % 3
            waits = rng.exponential(size=n).tolist()
            e2e = (np.asarray(waits) + rng.exponential(size=n)).tolist()
            batch_s = float(rng.exponential())
            for m in (mine, ref):
                m.record_batch(b, queue_waits=waits, e2e=e2e,
                               batch_s=batch_s)
        assert mine.snapshot() == ref.snapshot()
        for bb in buckets:
            assert mine.mean_batch_seconds(bb) == ref.mean_batch_seconds(bb)


# ---------------------------------------------------------------------------
# The warm plan pool against the reference's
# ---------------------------------------------------------------------------

def _memo(grown) -> dict:
    """A regrow memo with the dtype named as numpy names it."""
    return {(k, tuple(s), str(d).replace("torch.", "")): tuple(v)
            for (k, s, d), v in grown.items()}


@pytest.mark.parametrize("filtration,buckets", [
    ("superlevel", ((8, 8),)),
    ("sublevel", ((6, 10),)),
])
def test_warmup_matches_reference(filtration, buckets):
    """Same worst-case dummy, same memo keys: the reference's plan and
    build counts, regrow log and grown capacities — then a warmed server
    builds nothing and regrows nothing over a stream."""
    kw = dict(max_features=8, max_candidates=8, filtration=filtration)
    eng = _engine(serve=ServeSpec(buckets=buckets, batch_cap=2,
                                  tick_interval_s=0.0), **kw)
    jeng = JEngine(JConfig(serve=JServeSpec(buckets=buckets, batch_cap=2,
                                            tick_interval_s=0.0), **kw))
    info, jinfo = eng.warmup(), jeng.warmup()
    assert (info["plans"], info["traces"]) == \
        (jinfo["plans"], jinfo["traces"])
    assert info["plans"] > 2 * len(buckets)     # the chains regrew
    assert _memo(eng._grown) == _memo(jeng._grown)
    assert [(e["kind"], tuple(e["from"]), tuple(e["to"]))
            for e in eng.regrow_log] == \
        [(e["kind"], tuple(e["from"]), tuple(e["to"]))
         for e in jeng.regrow_log]
    # The tier is the checkerboard's: ceil(h/2) * ceil(w/2) features.
    for h, w in buckets:
        mf, _ = eng._grown[("batched", (2, h, w), "torch.float32")]
        assert mf >= -(-h // 2) * -(-w // 2)
    imgs = [_bumpy(i, s) for i, s in enumerate(
        [(6, 5), (4, 8), buckets[0], (5, 7), (3, 3), (2, 8)])]
    regrows = len(eng.regrow_log)
    with PHServer(eng) as srv:
        srv.warmup()
        results = [srv.submit(im).result(timeout=120) for im in imgs]
        assert srv.steady_state_traces() == 0
    assert len(eng.regrow_log) == regrows
    for im, res in zip(imgs, results):
        _same(eng.run(im, truncate_value=res.threshold), res)


def test_warmup_needs_buckets_and_stages_through_the_pool():
    with pytest.raises(ValueError):
        _engine().warmup()
    eng = _engine(overlap=OverlapSpec())
    info = eng.warmup(bucket_shapes=(8, (6, 10)), batch_sizes=(2, 3))
    # Per bucket: the single plan and one batched plan per batch size.
    assert info["plans"] == info["traces"] == 2 * 3
    assert set(_memo(eng._grown)) <= {
        ("single", (8, 8), "float32"), ("single", (6, 10), "float32")} | {
        ("batched", (b, *s), "float32") for b in (2, 3)
        for s in ((8, 8), (6, 10))}
    # Donation: the warmed staging slots wait in the pool for steady state.
    assert sum(len(v) for v in eng.staging._idle.values()) == 4
    again = eng.warmup(bucket_shapes=(8, (6, 10)), batch_sizes=(2, 3))
    assert again["plans"] == again["traces"] == 0


# ---------------------------------------------------------------------------
# Served diagrams against the reference's daemon
# ---------------------------------------------------------------------------

def test_served_results_equal_reference_server():
    imgs = _mixed_images(seed=4, n=9)
    jspec = JServeSpec(buckets=BUCKETS, batch_cap=CAP, tick_interval_s=0.001)
    with JServer(JEngine(JConfig(serve=jspec))) as jsrv:
        want = [f.result(timeout=120) for f in
                [jsrv.submit(im) for im in imgs]]
    with PHServer(_engine(serve=SPEC)) as srv:
        got = [f.result(timeout=120) for f in
               [srv.submit(im) for im in imgs]]
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.threshold == g.threshold, i
        _same(w, g, f"request {i}")


def test_request_key_hashes_bfloat16_bits():
    a = torch.tensor([[1.0, -0.0], [2.5, 3.0]], dtype=torch.bfloat16)
    b = a.clone()
    b[0, 1] = 0.0                   # equal values, other bits
    key = PHServer._request_key
    assert key(a, None) == key(a.clone(), None)
    assert key(a, None) != key(b, None)
    assert key(a, None) != key(a.to(torch.float32), None)
    assert key(a, 1.0) != key(a, None)


# ---------------------------------------------------------------------------
# Serving cache tier
# ---------------------------------------------------------------------------

TIER_GRID = (4, 4)
TIER_SIZE = 48


def _tier_img(seed):
    return np.random.default_rng(seed).normal(
        size=(TIER_SIZE, TIER_SIZE)).astype(np.float32)


def _perturb(img, tiles, bump=5.0):
    out = img.copy()
    tr, tc = TIER_SIZE // TIER_GRID[0], TIER_SIZE // TIER_GRID[1]
    for t in tiles:
        r0, c0 = (t // TIER_GRID[1]) * tr, (t % TIER_GRID[1]) * tc
        out[r0 + tr // 2, c0 + tc // 2] += bump
    return out


def _serve_engine(**kw):
    kw.setdefault("delta", DeltaSpec(cache_entries=16))
    return _engine(
        filter_level=FilterLevel.VANILLA,
        tile=TileSpec(grid=TIER_GRID, max_features_per_tile=64,
                      max_candidates_per_tile=64),
        serve=ServeSpec(buckets=((TIER_SIZE, TIER_SIZE),), batch_cap=4,
                        tick_interval_s=0.0), **kw)


def _tiled_reference(frame, got, what):
    tile = got.config.tile
    want = jtiling.tiled_pixhomology(
        jnp.asarray(frame), grid=tile.grid,
        max_features=got.config.max_features,
        tile_max_features=tile.max_features_per_tile,
        tile_max_candidates=tile.max_candidates_per_tile, merge_keys="rank")
    for name, a, b in zip(want.diagram._fields, want.diagram, got.diagram):
        assert np.array_equal(np.asarray(a), b.numpy()), f"{what} {name}"


def test_server_exact_hash_hit_bypasses_queue():
    img = _tier_img(19)
    with PHServer(_serve_engine()) as srv:
        first = srv.submit(img).result(120)
        fut = srv.submit(img)
        assert fut.done()               # resolved on the submit thread
        hit = fut.result(0)
        assert hit is first and _host_rows(hit)
        snap = srv.stats()
        assert snap["cache"]["hits"] == 1 and snap["cache"]["misses"] == 1
        assert srv.metrics.cache_hits == 1
    _tiled_reference(img, hit, "tier")


def test_server_near_duplicate_rides_delta_path():
    img = _tier_img(20)
    near = _perturb(img, [6])
    eng = _serve_engine()
    with PHServer(eng) as srv:
        srv.submit(img).result(120)
        res = srv.submit(near).result(120)
        assert res.delta is not None and res.delta.hit == "partial"
        assert res.delta.n_dirty < res.delta.n_tiles
        cold = eng.run_tiled(near)
        for name, a, b in zip(cold.diagram._fields, cold.diagram,
                              res.diagram):
            assert torch.equal(a, b), name
        assert srv.cache_stats()["delta_store"]["partial_hits"] >= 1
    _tiled_reference(near, res, "near-dup")


def test_server_without_delta_config_has_no_tier():
    eng = _engine(
        filter_level=FilterLevel.VANILLA,
        serve=ServeSpec(buckets=((TIER_SIZE, TIER_SIZE),), batch_cap=4,
                        tick_interval_s=0.0))
    img = _tier_img(22)
    with PHServer(eng) as srv:
        res = srv.submit(img).result(120)
        assert res.delta is None
        snap = srv.stats()
        assert snap["cache"]["enabled"] is False
        assert snap["cache"]["hits"] == 0
    _held_to_reference([img], [res])


# ---------------------------------------------------------------------------
# Serving under the overlap engine: harvest-thread resolution
# ---------------------------------------------------------------------------

def test_server_async_harvest_bit_identical_under_hammer():
    spec = ServeSpec(buckets=((8, 8), (16, 16)), batch_cap=3,
                     tick_interval_s=0.001)
    eng = _engine(serve=spec, overlap=OverlapSpec())
    eng.warmup()
    shapes = [(6, 5), (8, 8), (12, 10), (16, 16)]
    imgs = [_bumpy(i, shapes[i % len(shapes)]) for i in range(16)]
    results = [None] * len(imgs)
    errs = []
    with PHServer(eng) as srv:
        srv.warmup()
        barrier = threading.Barrier(4)

        def hammer(k):
            try:
                barrier.wait(timeout=30)
                futs = [(i, srv.submit(imgs[i]))
                        for i in range(k, len(imgs), 4)]
                for i, f in futs:
                    results[i] = f.result(timeout=120)
            except Exception as e:          # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errs and all(r is not None for r in results)
        assert srv.steady_state_traces() == 0
        st = srv.stats()
    assert st["completed"] == len(imgs)
    assert st["overlap"]["dispatch_syncs"] == 0
    assert st["overlap"]["harvest_syncs"] > 0
    _held_to_reference(imgs, results)


def test_server_sync_and_async_harvest_agree():
    spec = ServeSpec(buckets=((8, 8),), batch_cap=2, tick_interval_s=0.001)
    imgs = [_bumpy(i) for i in range(5)]
    out, counters = {}, {}
    for label, overlap in (("sync", OverlapSpec(async_harvest=False)),
                           ("async", OverlapSpec())):
        eng = _engine(serve=spec, overlap=overlap)
        with PHServer(eng) as srv:
            futs = [srv.submit(im) for im in imgs]
            out[label] = [f.result(timeout=120) for f in futs]
        counters[label] = eng.overlap_counters.snapshot()
    for a, b in zip(out["sync"], out["async"]):
        assert a.threshold == b.threshold
        _same(a, b)
    assert counters["sync"]["dispatch_syncs"] > 0
    assert counters["sync"]["harvest_syncs"] == 0
    assert counters["async"]["dispatch_syncs"] == 0
    _held_to_reference(imgs, out["async"])


def test_server_shutdown_drains_harvest_thread():
    spec = ServeSpec(buckets=((8, 8),), batch_cap=2, tick_interval_s=0.001)
    eng = _engine(serve=spec, overlap=OverlapSpec())
    srv = PHServer(eng)
    futs = [srv.submit(_bumpy(i)) for i in range(6)]
    srv.shutdown(drain=True)
    assert all(f.done() and f.exception() is None for f in futs)


def test_async_harvest_bounds_batches_in_flight():
    """With the harvest held, the tick stages at most ``staging_depth``
    batches ahead of it; the rest wait in the bounded queue, so a stream
    with thresholds given (no statistic on the tick) meets admission
    instead of staging without end.  Released, every accepted request
    resolves to the reference's diagram."""
    depth, cap, max_queue = 2, 2, 2
    spec = ServeSpec(buckets=((8, 8),), batch_cap=cap, max_queue=max_queue,
                     tick_interval_s=0.0, admission="reject")
    eng = _engine(serve=spec, overlap=OverlapSpec(staging_depth=depth))
    eng.warmup()
    srv = PHServer(eng)
    gate, staged = threading.Event(), []
    finish = srv._finish_batch

    def held(bucket, reqs, pending, t0):
        gate.wait(60)
        finish(bucket, reqs, pending, t0)

    real_async = eng.run_batch_async

    def counted(*a, **kw):
        staged.append(1)
        return real_async(*a, **kw)

    srv._finish_batch = held
    eng.run_batch_async = counted
    imgs, futs, rejected = [], [], None
    try:
        for k in range(50):
            img = _bumpy(k)
            try:
                futs.append(srv.submit(img, truncate_value=0.5))
            except AdmissionError as exc:
                rejected = exc
                break
            imgs.append(img)
            time.sleep(0.02)            # the tick takes what it can
        n_staged = len(staged)
    finally:
        gate.set()
    assert srv.drain(120)
    st = srv.stats()
    srv.shutdown()
    assert rejected is not None
    assert n_staged <= depth
    assert len(futs) <= (depth + 1) * cap + max_queue
    assert st["rejected"] == 1 and st["completed"] == len(futs)
    _held_to_reference(imgs, [f.result(0) for f in futs])


@pytest.mark.parametrize("overlap", [None, OverlapSpec()])
def test_served_rows_are_pageable_copies(engine, overlap):
    """Each served row owns its memory: pageable, and no view of the
    batch's diagram (which would keep the whole batch alive)."""
    eng = engine if overlap is None else _engine(serve=SPEC, overlap=overlap)
    imgs = _mixed_images(seed=8, n=4)
    with PHServer(eng) as srv:
        results = [f.result(120) for f in [srv.submit(im) for im in imgs]]
    for res in results:
        for f in res.diagram:
            assert not f.is_pinned()
            assert f.untyped_storage().nbytes() == f.numel() * f.element_size()
    _held_to_reference(imgs, results)


def test_submit_copies_the_callers_buffer():
    """A caller that reuses its buffer after ``submit`` changes neither
    the queued request nor the cache tier's entry for it."""
    a, b = _tier_img(30), _tier_img(31)
    buf = a.copy()
    eng = _serve_engine()
    srv = PHServer(eng, start=False)
    first = srv.submit(buf)
    buf[:] = b                  # reused before the request is dispatched
    srv.start()
    got_a = first.result(120)
    hit = srv.submit(a)         # the tier's key is a's content
    assert hit.done() and hit.result(0) is got_a
    got_b = srv.submit(buf).result(120)
    srv.shutdown()
    _tiled_reference(a, got_a, "first request")
    _tiled_reference(b, got_b, "reused buffer")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", [[], ["--merge-impl", "boruvka"]])
def test_ph_serve_cli_on_the_host(capsys, merge):
    ph_serve.main(["--device", "cpu", "--buckets", "8", "16", "--clients",
                   "2", "--requests", "4", "--tick-ms", "0", *merge])
    out = capsys.readouterr().out
    head, body = out.split("\n", 1)
    assert head.startswith("warmup: ")
    assert json.loads(head[len("warmup: "):])["traces"] == 4
    stats = json.loads(body)
    assert stats["resolved"] == 8 and stats["device"] == "cpu"
    assert stats["serve"]["steady_state_traces"] == 0
    assert stats["serve"]["completed"] == 8

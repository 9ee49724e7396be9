"""SLO metrics for the PH serving daemon.

The port's own copy of ``repro.serving.metrics`` (numpy only, the same
definitions and the same snapshot layout).  Everything here is host-side
bookkeeping around the serving loop in :mod:`repro_torch.serving.server`:
per-bucket latency distributions (queue-wait and end-to-end), batch
occupancy, and admission counters.  The recorders are called from
several kinds of threads at once — client threads inside ``submit()``,
the daemon's tick thread and its harvest thread after each batch — so
every mutation goes through one lock per :class:`ServeMetrics` instance.

Metric definitions:

``queue_wait_s``
    Dispatch start minus submit time: how long a request sat in its
    bucket queue before the tick thread picked it up.  Pure scheduling
    latency — grows with load, shrinks with ``batch_cap``/tick rate.
``e2e_s``
    Result-ready minus submit time: what the client actually observes on
    the future (queue wait + padded-batch compute + host repair).
``occupancy``
    Real requests per dispatched batch divided by ``batch_cap``.  The
    daemon always dispatches the *fixed* shape ``(batch_cap, Hb, Wb)``
    (padding free rows by repeating a real request) so one warmed plan
    serves every tick; occupancy says how much of that fixed batch did
    useful work.
``rejected``
    Submissions refused at admission (queue at ``max_queue`` under the
    ``"reject"`` policy).
``cache_hits`` / ``cache_misses``
    Serving cache-tier outcomes: a hit is a submit whose exact request
    hash (image bytes + shape + dtype + threshold) matched a finished
    result — the future resolves on the submit thread and the request
    never enters a queue.  Eviction counts live on the
    :class:`repro_torch.cache.LRUCache` itself and are merged into
    ``PHServer.stats()``'s ``cache`` section.

Percentiles come from a fixed-capacity ring buffer (:class:`Reservoir`)
— O(capacity) memory however long the daemon runs, exact percentiles
over the most recent ``capacity`` samples (a sliding window, which is
what an SLO dashboard wants anyway).
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["Reservoir", "BucketMetrics", "ServeMetrics", "bucket_label"]


def bucket_label(bucket: tuple[int, int]) -> str:
    """``(H, W) -> "HxW"`` — JSON-friendly bucket key."""
    return f"{int(bucket[0])}x{int(bucket[1])}"


class Reservoir:
    """Fixed-capacity ring buffer of float samples with exact percentiles
    over the retained (most recent) window.  Thread-safe."""

    __slots__ = ("_buf", "_next", "_seen", "_lock")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._buf = np.empty(capacity, np.float64)
        self._next = 0          # ring write position
        self._seen = 0          # total samples ever added
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self._buf[self._next] = float(value)
            self._next = (self._next + 1) % self._buf.size
            self._seen += 1

    def extend(self, values) -> None:
        for v in values:
            self.add(v)

    def __len__(self) -> int:
        with self._lock:
            return self._seen

    def _window(self) -> np.ndarray:
        return self._buf[:min(self._seen, self._buf.size)]

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained window; ``0.0`` when no
        sample has been recorded yet (a freshly started server must
        expose zeroed — not raising, not NaN — latency stats)."""
        with self._lock:
            w = self._window()
            if w.size == 0:
                return 0.0
            return float(np.percentile(w, q))

    def summary(self) -> dict:
        """``{count, mean, p50, p95, p99, max}`` (seconds in, seconds
        out); all-zero when empty, so dashboards and checks can
        read every key of a fresh server without guards (single-sample
        windows are exact: every percentile is that sample)."""
        with self._lock:
            w = self._window()
            if w.size == 0:
                return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                        "p99": 0.0, "max": 0.0}
            p50, p95, p99 = np.percentile(w, [50.0, 95.0, 99.0])
            return {"count": self._seen,
                    "mean": float(w.mean()),
                    "p50": float(p50),
                    "p95": float(p95),
                    "p99": float(p99),
                    "max": float(w.max())}


class BucketMetrics:
    """Latency/throughput accounting for one shape bucket."""

    __slots__ = ("queue_wait_s", "e2e_s", "batch_s", "requests", "batches",
                 "rows", "rejected", "failed")

    def __init__(self, window: int = 4096):
        self.queue_wait_s = Reservoir(window)
        self.e2e_s = Reservoir(window)
        self.batch_s = Reservoir(window)    # per-dispatch compute+repair
        self.requests = 0                   # requests resolved successfully
        self.batches = 0                    # dispatches (incl. padded rows)
        self.rows = 0                       # real rows across dispatches
        self.rejected = 0
        self.failed = 0

    def occupancy(self, batch_cap: int) -> float | None:
        if self.batches == 0:
            return None
        return self.rows / (self.batches * batch_cap)

    def snapshot(self, batch_cap: int) -> dict:
        occ = self.occupancy(batch_cap)
        return {"requests": self.requests,
                "batches": self.batches,
                "rows": self.rows,
                "rejected": self.rejected,
                "failed": self.failed,
                "occupancy": None if occ is None else round(occ, 4),
                "queue_wait_s": self.queue_wait_s.summary(),
                "e2e_s": self.e2e_s.summary(),
                "batch_s": self.batch_s.summary()}


class ServeMetrics:
    """All-buckets metrics hub; one per
    :class:`~repro_torch.serving.PHServer`.

    The per-:class:`Reservoir` locks make individual samples safe; this
    object's own lock additionally keeps the counters and the bucket
    map consistent across the submit / tick threads.
    """

    def __init__(self, batch_cap: int, window: int = 4096):
        self.batch_cap = int(batch_cap)
        self._window = int(window)
        self._buckets: dict[tuple[int, int], BucketMetrics] = {}
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.cache_hits = 0
        self.cache_misses = 0

    def bucket(self, bucket: tuple[int, int]) -> BucketMetrics:
        key = (int(bucket[0]), int(bucket[1]))
        with self._lock:
            m = self._buckets.get(key)
            if m is None:
                m = self._buckets[key] = BucketMetrics(self._window)
            return m

    # -- recorders ---------------------------------------------------------

    def record_submit(self, bucket) -> None:
        self.bucket(bucket)  # ensure the bucket shows up in snapshots
        with self._lock:
            self.submitted += 1

    def record_reject(self, bucket) -> None:
        m = self.bucket(bucket)
        with self._lock:
            m.rejected += 1
            self.rejected += 1

    def record_cache(self, *, hit: bool) -> None:
        """One serving cache-tier lookup outcome (hits also count as a
        submitted+completed request: the client got a result)."""
        with self._lock:
            if hit:
                self.cache_hits += 1
                self.submitted += 1
                self.completed += 1
            else:
                self.cache_misses += 1

    def record_batch(self, bucket, *, queue_waits, e2e, batch_s) -> None:
        """One successful dispatch: ``queue_waits``/``e2e`` carry one
        sample per *real* request in the batch."""
        m = self.bucket(bucket)
        m.queue_wait_s.extend(queue_waits)
        m.e2e_s.extend(e2e)
        m.batch_s.add(batch_s)
        with self._lock:
            m.requests += len(e2e)
            m.batches += 1
            m.rows += len(e2e)
            self.completed += len(e2e)

    def record_failure(self, bucket, n_requests: int) -> None:
        m = self.bucket(bucket)
        with self._lock:
            m.failed += n_requests
            self.failed += n_requests

    def mean_batch_seconds(self, bucket) -> float | None:
        m = self.bucket(bucket)
        s = m.batch_s.summary()
        return s["mean"] if s["count"] else None

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready view: global counters + per-bucket summaries keyed
        ``"HxW"``."""
        with self._lock:
            buckets = dict(self._buckets)
            top = {"submitted": self.submitted,
                   "completed": self.completed,
                   "failed": self.failed,
                   "rejected": self.rejected,
                   "batch_cap": self.batch_cap,
                   "cache": {"hits": self.cache_hits,
                             "misses": self.cache_misses}}
        top["buckets"] = {bucket_label(k): m.snapshot(self.batch_cap)
                          for k, m in sorted(buckets.items())}
        return top

"""PH-as-a-service: an async serving daemon over one shared PHEngine.

Counterpart of ``repro.serving.server``.  A service sees many independent
clients, one image each, shapes mixed, arrival times arbitrary; this
daemon keeps the engine's plans warm and turns request streams into the
fixed-shape batches those plans want:

``submit(image, truncate_value) -> concurrent.futures.Future[PHResult]``
    Clients enqueue and move on; the future resolves with exactly what
    ``PHEngine.run(image, truncate_value)`` would have returned
    (bit-identical — padding artifacts are repaired by
    :mod:`repro_torch.pipeline.padding` inside the engine's batch path),
    its diagram a row of host tensors in pageable memory, copied out of
    the batch.  ``image`` is a numpy array or a tensor on any device;
    ``submit`` copies it to the host, so the caller may reuse its buffer.

**Coalescing tick**: one daemon thread blocks until work arrives, sleeps
one ``tick_interval_s`` so concurrent submitters land in the same tick,
then drains every non-empty bucket queue, up to ``batch_cap`` requests
per bucket per pass.  Under sustained load the loop never sleeps —
continuous batching.

**Fixed dispatch shape**: a partially filled batch is padded to exactly
``(batch_cap, Hb, Wb)`` by repeating a real request, so every dispatch of
a bucket reuses the *one* plan :meth:`PHServer.warmup` built for it.
With the warmup dummy that pre-walks the regrow chain
(:meth:`repro_torch.ph.engine.PHEngine.warmup`), steady state builds
nothing and regrows nothing; :meth:`PHServer.steady_state_traces`
measures the first.

**The statistic on the tick thread**: requests without a threshold get
the Variant-2 statistic of ``config.filter_level`` inside the batch path,
on the tick thread, once per row (pad rows included), as the reference's
daemon does.

**Serving cache tier** (active when the engine's ``config.delta`` is
enabled): ``submit`` hashes the request — image bytes (bfloat16 through
its int16 view) + shape + dtype + threshold — and an exact match against
a bounded :class:`repro_torch.cache.LRUCache` of finished results
resolves the future on the *submit thread*; the request never enters a
queue, never pads a batch, never touches the device.  Misses dispatch
one by one through :meth:`repro_torch.ph.PHEngine.run_delta`, so a
near-duplicate of a recent frame recomputes only its changed tiles; the
finished result, its diagram copied to host memory, is inserted into the
tier.  Hit/miss counters live in
:class:`repro_torch.serving.metrics.ServeMetrics`; evictions on the LRU
itself; both surface in :meth:`PHServer.stats` under ``"cache"``.

**Admission control**: each bucket queue is bounded by ``max_queue``.
At the bound, the ``"reject"`` policy raises :class:`AdmissionError`
carrying a ``retry_after_s`` hint (estimated from the queue depth and
recent batch latency); the ``"block"`` policy parks the submitting
thread until space frees.  ``shutdown(drain=True)`` stops admission,
lets the tick thread finish every queued request, and joins it;
``drain=False`` fails undispatched futures instead.

Thread model: client threads run ``submit`` (queue + metrics + the
request hash, no device work).  The tick thread runs every dispatch.
With ``OverlapSpec(async_harvest=True)`` a dispatch only stages and
uploads the batch (``run_batch_async``); the harvest thread runs
``resolve()`` — in the port the computation itself, since phases B and C
read back — and resolves the futures.  At most ``staging_depth`` batches
are between the two: the tick waits for a harvest to finish before it
stages another, so a tick that outruns the harvest leaves requests in the
bounded queues, where admission sees them.  Both threads enter
``torch.cuda.device(engine.device)``: the current device and stream are
per thread, and the kernels launch on the current stream.  The shared
engine is internally locked (plan cache, regrow memo).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.cache import LRUCache
from repro_torch.core import Diagram
from repro_torch.ph.config import ServeSpec
from repro_torch.ph.engine import PHEngine, PHResult, as_host_tensor
from repro_torch.ph.overlap import map_tensors
from repro_torch.pipeline.scheduler import assign_bucket
from repro_torch.serving.metrics import ServeMetrics

__all__ = ["AdmissionError", "PHServer"]

# Bound on the exact-result tier: entries are host-side results, so the
# tier can afford far more entries than the device-resident delta frame
# store (DeltaSpec.cache_entries).
CACHE_TIER_ENTRIES = 256


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when a bucket queue is full under the
    ``"reject"`` admission policy.  ``retry_after_s`` estimates when the
    queue should have space (depth worth of batches at the recent
    per-batch latency)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class _Request:
    __slots__ = ("image", "truncate_value", "bucket", "future", "t_submit",
                 "cache_key")

    def __init__(self, image, truncate_value, bucket, cache_key=None):
        self.image = image
        self.truncate_value = truncate_value
        self.bucket = bucket
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.cache_key = cache_key


def _device_scope(device: torch.device):
    """The calling thread's current CUDA device set to ``device`` (nothing
    to set for a host engine)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _pageable(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in pageable host memory of its own: no view of a
    pinned or batch-sized buffer outlives the batch that made it."""
    telemetry.readback(t.device)
    return torch.empty(t.shape, dtype=t.dtype).copy_(t)


def _host_result(res: PHResult) -> PHResult:
    """``res`` with its diagram copied to pageable host memory."""
    return dataclasses.replace(res, diagram=map_tensors(_pageable,
                                                        res.diagram))


class PHServer:
    """Async PH daemon: bucketed continuous batching over one engine.

    ``engine``: the shared :class:`PHEngine`; its ``config.serve``
    (:class:`ServeSpec`) supplies the bucket set and serving knobs (a
    default spec is used when absent — dynamic pow-2 buckets, which serve
    correctly but cannot be fully pre-warmed).  The daemon runs on the
    engine's device: the CUDA device unless the engine was made with
    ``device="cpu"``.

    Lifecycle: construct (``start=True`` spawns the tick thread
    immediately), optionally :meth:`warmup`, ``submit`` at will, then
    :meth:`shutdown` — or use it as a context manager, which shuts down
    with a full drain::

        with PHServer(engine) as srv:
            srv.warmup()
            futs = [srv.submit(img) for img in images]
            diagrams = [f.result().diagram for f in futs]
    """

    def __init__(self, engine: PHEngine, *, start: bool = True,
                 spec: ServeSpec | None = None):
        if not isinstance(engine, PHEngine):
            raise TypeError(f"engine must be a PHEngine, "
                            f"got {type(engine).__name__}")
        self.engine = engine
        # ``spec`` overrides the engine config's serve spec — legitimate
        # for the host-side knobs (max_queue / tick / admission), which
        # never enter plan_key; keep buckets/batch_cap matched to the
        # engine's warmed plans or warmup() again.
        if spec is None:
            spec = engine.config.serve \
                if engine.config.serve is not None else ServeSpec()
        self.spec: ServeSpec = spec
        self.metrics = ServeMetrics(self.spec.batch_cap)
        # Cache tier: active only when the engine opts into delta compute
        # (config.delta enabled) — exact request hashes short-circuit at
        # submit, near-duplicates dispatch through run_delta.
        dspec = engine.config.delta
        self._delta_serving = dspec is not None and dspec.enabled
        self._cache: LRUCache | None = \
            LRUCache(CACHE_TIER_ENTRIES) if self._delta_serving else None
        self._cond = threading.Condition()
        self._queues: dict[tuple[int, int], deque[_Request]] = {}
        if self.spec.buckets is not None:
            for b in self.spec.buckets:     # fixed set, smallest-first
                self._queues[b] = deque()
        # Accepting from construction: a not-yet-started server queues
        # submissions and dispatches them once start() spawns the tick
        # thread.  Only shutdown() stops admission.
        self._accepting = True
        self._stop = False
        self._inflight = 0
        self._thread: threading.Thread | None = None
        self._warm_traces: int | None = None
        # Overlap engine: with async_harvest on, the tick thread only
        # *dispatches* batches — futures resolve (and in-flight counts
        # drop) on this harvest thread, so the tick never blocks on the
        # computation.  The delta path keeps its synchronous per-request
        # dispatch (the cache tier inserts on completion).
        ospec = engine.overlap_spec()
        # ``staging_depth`` bounds the batches between tick and harvest
        # (each holds a staging slot and its device batch).
        self._harvest: ThreadPoolExecutor | None = None
        if ospec.enabled and ospec.async_harvest and not self._delta_serving:
            self._harvest = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ph-serve-harvest")
            self._harvest_slots = threading.Semaphore(ospec.staging_depth)
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._cond:
            if self._thread is not None:
                raise RuntimeError("PHServer already started")
            if not self._accepting:
                raise RuntimeError("PHServer was shut down")
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name="ph-serve-tick", daemon=True)
            self._thread.start()

    def warmup(self, **kwargs) -> dict:
        """Build the serving plans and walk their regrow chains (delegates
        to :meth:`PHEngine.warmup`), then snapshot the engine's build
        counter; :meth:`steady_state_traces` counts from here."""
        info = self.engine.warmup(**kwargs)
        self._warm_traces = self.engine.plan_stats()["traces"]
        return info

    def steady_state_traces(self) -> int | None:
        """Plan builds since :meth:`warmup` (``None`` before warmup).  Zero
        on a warmed server is the whole point of the warm pool."""
        if self._warm_traces is None:
            return None
        return self.engine.plan_stats()["traces"] - self._warm_traces

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every queued and in-flight request has resolved
        (or ``timeout`` elapses).  Returns True when fully drained."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._inflight == 0
                and not any(self._queues.values()), timeout)

    def shutdown(self, *, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Stop admission and the tick thread.  ``drain=True`` (default)
        lets every already-queued request run to completion first;
        ``drain=False`` fails undispatched futures with ``RuntimeError``
        (an in-flight batch still completes)."""
        with self._cond:
            self._accepting = False
            if not drain or self._thread is None:
                # No tick thread -> nothing will ever drain the queues.
                for q in self._queues.values():
                    while q:
                        q.popleft().future.set_exception(RuntimeError(
                            "PHServer shut down before dispatch"))
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._harvest is not None:
            # In-flight batches finish resolving on the harvest thread
            # before shutdown returns (their futures must not dangle).
            self._harvest.shutdown(wait=True)
            self._harvest = None

    def __enter__(self) -> "PHServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- client API --------------------------------------------------------

    def submit(self, image, truncate_value: float | None = None) -> Future:
        """Enqueue one 2D image (a numpy array or a tensor); returns a
        future resolving to the :class:`PHResult` of ``engine.run(image,
        truncate_value)`` (computed inside a padded bucket batch, repaired
        bit-identical; its diagram a row of host tensors).

        Raises :class:`AdmissionError` when the bucket queue is full under
        the ``"reject"`` policy; blocks under ``"block"``; ``ValueError``
        for non-2D images or shapes exceeding the largest configured
        bucket; ``RuntimeError`` once shut down.
        """
        img = as_host_tensor(image).detach().to("cpu", copy=True)
        if img.dim() != 2:
            raise ValueError(f"expected a 2D image, got shape "
                             f"{tuple(img.shape)}")
        bucket = assign_bucket(tuple(img.shape), self.spec.buckets,
                               self.engine.config.bucket_rounding)
        if bucket is None:
            raise ValueError(
                f"image shape {tuple(img.shape)} exceeds the largest serve "
                f"bucket {self.spec.buckets[-1]}")
        cache_key = None
        if self._cache is not None:
            cache_key = self._request_key(img, truncate_value)
            with self._cond:
                accepting = self._accepting
            if accepting:
                got = self._cache.get(cache_key)
                if got is not None:
                    # Exact-hash hit: the computation is deterministic, so
                    # the stored PHResult *is* this request's answer.  No
                    # queue, no batch, no device work.
                    self.metrics.record_cache(hit=True)
                    fut: Future = Future()
                    fut.set_result(got)
                    return fut
                self.metrics.record_cache(hit=False)
        req = _Request(img, truncate_value, bucket, cache_key)
        with self._cond:
            if not self._accepting:
                raise RuntimeError("PHServer is not accepting requests")
            q = self._queues.setdefault(bucket, deque())
            if len(q) >= self.spec.max_queue:
                if self.spec.admission == "reject":
                    self.metrics.record_reject(bucket)
                    retry = self._retry_after(bucket)
                    raise AdmissionError(
                        f"bucket {bucket} queue full "
                        f"({self.spec.max_queue}); retry in ~{retry:.3g}s",
                        retry)
                self._cond.wait_for(
                    lambda: len(q) < self.spec.max_queue
                    or not self._accepting)
                if not self._accepting:
                    raise RuntimeError(
                        "PHServer shut down while blocked on admission")
            q.append(req)
            self.metrics.record_submit(bucket)
            self._cond.notify_all()
        return req.future

    def stats(self) -> dict:
        """Serving metrics snapshot + engine plan stats +
        ``steady_state_traces`` + cache-tier and overlap counters."""
        snap = self.metrics.snapshot()
        snap["engine"] = self.engine.plan_stats()
        snap["steady_state_traces"] = self.steady_state_traces()
        snap["cache"] = self.cache_stats()
        snap["overlap"] = self.engine.overlap_counters.snapshot()
        return snap

    # -- cache tier --------------------------------------------------------

    @staticmethod
    def _request_key(img: torch.Tensor, truncate_value) -> tuple:
        """Exact request identity: content digest (bfloat16 hashed through
        its int16 view, as the engine's dedupe does) + shape + dtype +
        threshold.  Equal keys imply bit-identical results (the engine is
        deterministic), so a cached result can stand in for compute."""
        x = img.contiguous()
        raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        digest = hashlib.blake2b(raw.numpy().tobytes(),
                                 digest_size=16).digest()
        return (tuple(x.shape), str(x.dtype), digest,
                None if truncate_value is None else float(truncate_value))

    def cache_stats(self) -> dict:
        """Cache-tier counters: submit-side hit/miss (from
        :class:`ServeMetrics`), the LRU's own insert/evict counters, and
        the engine's delta frame-store counters."""
        out = {"enabled": self._delta_serving,
               "hits": self.metrics.cache_hits,
               "misses": self.metrics.cache_misses}
        if self._cache is not None:
            lru = self._cache.stats
            out.update(entries=len(self._cache), inserts=lru.inserts,
                       evictions=lru.evictions)
        out["delta_store"] = self.engine.delta_cache_stats()
        return out

    # -- daemon ------------------------------------------------------------

    def _retry_after(self, bucket) -> float:
        """Full-queue backoff hint: batches needed to drain the queue
        times the recent per-batch latency (tick interval when no batch
        has completed yet)."""
        per_batch = self.metrics.mean_batch_seconds(bucket)
        if per_batch is None:
            per_batch = self.spec.tick_interval_s
        batches = max(1, -(-self.spec.max_queue // self.spec.batch_cap))
        return batches * max(per_batch, self.spec.tick_interval_s)

    def _next_batch(self):
        """Pop up to ``batch_cap`` requests of the first non-empty bucket
        and count them in flight; ``None`` when every queue is empty."""
        with self._cond:
            bucket = next((b for b, q in self._queues.items() if q), None)
            if bucket is None:
                return None
            q = self._queues[bucket]
            reqs = [q.popleft() for _ in
                    range(min(len(q), self.spec.batch_cap))]
            self._inflight += len(reqs)
            self._cond.notify_all()     # blocked submitters: space freed
            return bucket, reqs

    def _loop(self) -> None:
        cond = self._cond
        with _device_scope(self.engine.device):
            while True:
                with cond:
                    cond.wait_for(lambda: self._stop
                                  or any(self._queues.values()))
                    if self._stop and not any(self._queues.values()):
                        return
                # Coalescing window: submitters racing this tick get in.
                if self.spec.tick_interval_s > 0 and not self._stop:
                    time.sleep(self.spec.tick_interval_s)
                while (batch := self._next_batch()) is not None:
                    bucket, reqs = batch
                    deferred = False
                    try:
                        deferred = self._dispatch(bucket, reqs)
                    finally:
                        if not deferred:
                            self._release(len(reqs))

    def _release(self, n: int) -> None:
        with self._cond:
            self._inflight -= n
            self._cond.notify_all()     # drain()/shutdown waiters

    def _dispatch(self, bucket, reqs) -> bool:
        """Run one bucket micro-batch and resolve its futures.  A raise
        anywhere in compute fails *this round's* futures only — the loop
        (and every other queued request) carries on.

        Returns True when resolution was handed to the harvest thread
        (async harvest): the futures resolve there, bit-identically to
        the synchronous path — same :meth:`_finish_batch` on another
        thread — and the in-flight accounting follows them."""
        if self._delta_serving:
            self._dispatch_delta(bucket, reqs)
            return False
        t0 = time.perf_counter()
        imgs = [r.image for r in reqs]
        tvs = [r.truncate_value for r in reqs]
        pad = self.spec.batch_cap - len(imgs)
        if pad > 0:
            # Fixed dispatch shape (batch_cap, Hb, Wb): repeat a real
            # request into the free rows so the warmed plan always fits.
            imgs = imgs + [imgs[0]] * pad
            tvs = tvs + [tvs[0]] * pad
        if self._harvest is not None:
            self._harvest_slots.acquire()   # released by the harvest
        try:
            # dedupe=False: the warmed plans require the fixed dispatch
            # shape; exact duplicates are the cache tier's job anyway.
            # With the overlap engine this only stages and uploads.
            pending = self.engine.run_batch_async(imgs, tvs, bucket=bucket,
                                                  dedupe=False)
        except Exception as exc:        # noqa: BLE001 — isolate the round
            if self._harvest is not None:
                self._harvest_slots.release()
            for r in reqs:
                r.future.set_exception(exc)
            self.metrics.record_failure(bucket, len(reqs))
            return False
        if self._harvest is not None:
            self._harvest.submit(self._harvest_batch, bucket, reqs,
                                 pending, t0)
            return True
        self.engine.overlap_counters.bump("dispatch_syncs")
        self._finish_batch(bucket, reqs, pending, t0)
        return False

    def _harvest_batch(self, bucket, reqs, pending, t0) -> None:
        """Harvest-thread entry: resolve the batch on the engine's device,
        then free its place between tick and harvest and its in-flight
        requests (drain()/shutdown wait on exactly this)."""
        try:
            self.engine.overlap_counters.bump("harvest_syncs")
            with _device_scope(self.engine.device):
                self._finish_batch(bucket, reqs, pending, t0)
        finally:
            self._harvest_slots.release()
            self._release(len(reqs))

    def _finish_batch(self, bucket, reqs, pending, t0) -> None:
        """Materialize one dispatched batch and resolve its futures with
        host rows — the blocking half of :meth:`_dispatch`, runnable on
        either the tick thread (sync) or the harvest thread (async)."""
        try:
            out = pending.resolve()
            # Each row copied to pageable host memory (from the card, or
            # from the pinned batch the engine streamed), so a kept result
            # holds neither the batch nor page-locked memory.
            rows = [Diagram(*(_pageable(f[i]) for f in out.diagram))
                    for i in range(len(reqs))]
        except Exception as exc:        # noqa: BLE001 — isolate the round
            for r in reqs:
                r.future.set_exception(exc)
            self.metrics.record_failure(bucket, len(reqs))
            return
        t1 = time.perf_counter()
        thr = None if out.threshold is None else np.asarray(out.threshold)
        for i, (r, row) in enumerate(zip(reqs, rows)):
            r.future.set_result(PHResult(
                row, out.config, out.regrow,
                None if thr is None else float(thr[i])))
        self.metrics.record_batch(
            bucket,
            queue_waits=[t0 - r.t_submit for r in reqs],
            e2e=[t1 - r.t_submit for r in reqs],
            batch_s=t1 - t0)

    def _dispatch_delta(self, bucket, reqs) -> None:
        """Delta-serving round: each request runs through
        :meth:`PHEngine.run_delta` — near-duplicates of recent frames
        recompute only their dirty tiles — and the finished result, its
        diagram in host memory, is inserted into the exact-hash tier so an
        identical future request never reaches dispatch at all.  A
        per-request raise fails that future only."""
        t0 = time.perf_counter()
        done: list[_Request] = []
        for r in reqs:
            try:
                res = _host_result(self.engine.run_delta(r.image,
                                                         r.truncate_value))
            except Exception as exc:    # noqa: BLE001 — isolate the request
                r.future.set_exception(exc)
                self.metrics.record_failure(bucket, 1)
                continue
            if self._cache is not None and r.cache_key is not None:
                self._cache.put(r.cache_key, res)
            r.future.set_result(res)
            done.append(r)
        t1 = time.perf_counter()
        if done:
            self.metrics.record_batch(
                bucket,
                queue_waits=[t0 - r.t_submit for r in done],
                e2e=[t1 - r.t_submit for r in done],
                batch_s=t1 - t0)

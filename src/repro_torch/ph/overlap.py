"""Overlap-engine primitives: pinned D2H streaming, the staging pool,
transfer counters, deferred results.

Counterpart of ``repro.ph.overlap``.  The reference's overlapped dispatch
is one asynchronous XLA program: the dispatch thread launches it and a
harvest thread reads the results back.  The port's phases B and C read
back to the host *inside* the computation (one readback per Boruvka round
and per pointer doubling), so launching the computation would block
whichever thread launches it.  The port therefore splits a round this way:

* the **dispatch side** (``PHEngine.run_batch_async``,
  ``ShardedPHExecutor.load_round`` / ``begin_staged``,
  ``begin_regrow(stream=True)``) enqueues only non-blocking work: the
  pinned host-to-device copy of the batch and its thresholds on a copy
  stream (:class:`StagingPool`), and an event after it;
* **``resolve()``** (on the driver's harvest thread) runs everything that
  can read back: the compute stream waits on the upload's event, then the
  computation, the overflow check and regrow, the pad repair, and the
  device-to-host copy of the results (:func:`start_d2h`).

The counters (:class:`OverlapCounters`) keep the reference's meaning:
one upload group per staged round (its batch, its thresholds and every
device's rows count once), one D2H group per streamed output, blocking
reads on the dispatch thread (zero with the overlap on: that thread only
enqueues) and on the harvest thread.  A staged buffer is never consumed
by the computation that reads it, so a regrow replay reads the same
device buffer and no round is staged twice: nothing is ever re-staged.

``resolve()`` runs in the :mod:`contextvars` context the pending result
was made in, so the :mod:`repro_torch.telemetry` spans a harvest thread
opens belong to the call that dispatched the round.

Nothing here changes numerics: every overlapped path resolves to the bytes
the synchronous path gives.
"""
from __future__ import annotations

import contextvars
import threading
from typing import Any, Callable

import torch

from repro_torch import telemetry

__all__ = ["HostCopy", "OverlapCounters", "PendingResult", "StagingPool",
           "StagingSlot", "map_tensors", "start_d2h"]


class OverlapCounters:
    """Thread-safe transfer/sync counters for the overlap engine.

    ``h2d_transfers``
        upload groups issued by staging (a round's batch and thresholds
        count once).
    ``d2h_streams``
        device-to-host copy groups started (one per streamed output).
    ``dispatch_syncs``
        blocking device reads on the *dispatch* thread (the pipeline
        driver's loop).  Zero in steady state with overlap on.
    ``harvest_syncs``
        blocking reads where they belong: on a harvest thread (or inside
        an explicit ``resolve()``).
    """

    FIELDS = ("h2d_transfers", "d2h_streams", "dispatch_syncs",
              "harvest_syncs")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def bump(self, field: str, k: int = 1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown overlap counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + k)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a tree of tuples (named tuples
    included), lists and dicts; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


class HostCopy:
    """A tree whose CUDA leaves are being copied into pinned host memory;
    :meth:`result` waits on the copies' events and returns the host
    tree."""

    __slots__ = ("_tree", "_events")

    def __init__(self, tree: Any, events: list):
        self._tree = tree
        self._events = events

    def result(self) -> Any:
        for ev in self._events:
            telemetry.readback()
            ev.synchronize()
        return self._tree


def start_d2h(tree: Any, counters: OverlapCounters | None = None
              ) -> HostCopy:
    """Begin non-blocking device-to-host copies of every CUDA tensor leaf.

    Per device, a side stream waits on the producing (current) stream,
    copies each leaf into a pinned host tensor with ``non_blocking=True``
    and records one event; :meth:`HostCopy.result` waits on those events.
    Host leaves pass through as they are.  One ``d2h_streams`` bump per
    group that copies anything.
    """
    streams: dict = {}

    def copy(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return x
        side = streams.get(x.device)
        if side is None:
            side = torch.cuda.Stream(device=x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            streams[x.device] = side
        with torch.cuda.stream(side):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
        x.record_stream(side)
        return host

    host_tree = map_tensors(copy, tree)
    events = []
    for side in streams.values():
        ev = torch.cuda.Event()
        ev.record(side)
        events.append(ev)
    if streams and counters is not None:
        counters.bump("d2h_streams")
    return HostCopy(host_tree, events)


class StagingSlot:
    """Engine-owned buffers of one staged batch: a host batch and its
    thresholds (pinned when a device is a CUDA device), and each device's
    rows of both (views of the host buffers on a CPU device)."""

    def __init__(self, key: tuple, devices, shape, dtype, tdtype):
        m = shape[0]
        if m % len(devices):
            raise ValueError(f"{m} rows do not split over {len(devices)} "
                             f"devices")
        per = m // len(devices)
        pin = any(d.type == "cuda" for d in devices)
        self.key = key
        self.devices = tuple(devices)
        self.host_batch = torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.host_tvals = torch.empty((m,), dtype=tdtype, pin_memory=pin)
        self.batch, self.tvals = [], []
        for i, d in enumerate(self.devices):
            rows = slice(i * per, (i + 1) * per)
            if d.type == "cuda":
                self.batch.append(torch.empty((per, *shape[1:]),
                                              dtype=dtype, device=d))
                self.tvals.append(torch.empty((per,), dtype=tdtype,
                                              device=d))
            else:
                self.batch.append(self.host_batch[rows])
                self.tvals.append(self.host_tvals[rows])
        self.fresh = True       # device buffers not yet ordered on a stream
        self.uploaded: list = [None] * len(self.devices)
        self.released: list = []

    def idle(self) -> bool:
        """True once every computation that read the slot has finished."""
        return all(ev.query() for ev in self.released)

    def ready(self) -> tuple[list, list]:
        """Each device's rows, usable on the calling thread's current
        streams: they wait on the upload's events (nothing blocks)."""
        for i, ev in enumerate(self.uploaded):
            if ev is not None:
                s = torch.cuda.current_stream(self.devices[i])
                s.wait_event(ev)
                self.batch[i].record_stream(s)
                self.tvals[i].record_stream(s)
        return self.batch, self.tvals


class StagingPool:
    """Staging buffers for engine-built batches (the port's form of the
    reference's buffer donation).

    :meth:`acquire` hands out a :class:`StagingSlot` for a batch shape; the
    caller fills its host buffers, :meth:`upload` copies each device's
    rows on that device's copy stream with ``non_blocking=True`` (one
    event per device), and :meth:`release`, called after the computation
    that read the slot was enqueued, records an event on each device's
    current stream.  With ``reuse`` a released slot returns to the pool
    and is handed out again only once those events have completed, so a
    reused slot never changes a result still being computed; without it
    every batch gets fresh buffers (the caching allocators reuse them).
    Slots hold only engine-built copies, never a caller's tensor.
    """

    def __init__(self, reuse: bool = True):
        self.reuse = reuse
        self._lock = threading.Lock()
        self._idle: dict[tuple, list[StagingSlot]] = {}
        self._copy_streams: dict = {}

    def acquire(self, devices, shape, dtype, tdtype) -> StagingSlot:
        key = (tuple(devices), tuple(shape), dtype, tdtype)
        if self.reuse:
            with self._lock:
                pool = self._idle.get(key, [])
                for i, slot in enumerate(pool):
                    if slot.idle():
                        return pool.pop(i)
        return StagingSlot(key, devices, tuple(shape), dtype, tdtype)

    def _copy_stream(self, device):
        with self._lock:
            s = self._copy_streams.get(device)
            if s is None:
                s = self._copy_streams[device] = torch.cuda.Stream(
                    device=device)
            return s

    def upload(self, slot: StagingSlot) -> StagingSlot:
        """Enqueue the slot's host-to-device copies (one group, an
        ``upload`` span)."""
        with telemetry.span("upload"):
            per = slot.host_batch.shape[0] // len(slot.devices)
            for i, d in enumerate(slot.devices):
                if d.type != "cuda":
                    continue
                rows = slice(i * per, (i + 1) * per)
                cs = self._copy_stream(d)
                if slot.fresh:       # allocated on the current stream
                    cs.wait_stream(torch.cuda.current_stream(d))
                with torch.cuda.stream(cs):
                    slot.batch[i].copy_(slot.host_batch[rows],
                                        non_blocking=True)
                    slot.tvals[i].copy_(slot.host_tvals[rows],
                                        non_blocking=True)
                slot.batch[i].record_stream(cs)
                slot.tvals[i].record_stream(cs)
                ev = torch.cuda.Event()
                ev.record(cs)
                slot.uploaded[i] = ev
            slot.fresh = False
        return slot

    def release(self, slot: StagingSlot) -> None:
        """Mark the slot's readers enqueued; reuse waits on their events."""
        events = []
        for d in slot.devices:
            if d.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                events.append(ev)
        slot.released = events
        if self.reuse:
            with self._lock:
                self._idle.setdefault(slot.key, []).append(slot)


class PendingResult:
    """A deferred result: ``resolve()`` runs ``finish`` exactly once
    (memoized, thread-safe) and returns its value thereafter.

    ``finish`` performs whatever the dispatch side deferred — in the port
    the computation itself, the overflow check, the regrow-and-replay
    loop and the host materialization — so callers choose *where* that
    blocking happens (inline for the synchronous API, a harvest thread for
    the overlapped one).  An exception raised by ``finish`` is re-raised
    on every later ``resolve()``.  ``finish`` runs in a copy of the
    context the pending result was made in.
    """

    __slots__ = ("_finish", "_context", "_lock", "_done", "_value", "_exc")

    def __init__(self, finish: Callable[[], Any]):
        self._finish = finish
        self._context = contextvars.copy_context()
        self._lock = threading.Lock()
        self._done = False
        self._value = None
        self._exc: BaseException | None = None

    def resolve(self) -> Any:
        with self._lock:
            if not self._done:
                try:
                    self._value = self._context.run(self._finish)
                except BaseException as exc:
                    self._exc = exc
                finally:
                    self._done = True
                    self._finish = self._context = None   # drop buffers
            if self._exc is not None:
                raise self._exc
            return self._value

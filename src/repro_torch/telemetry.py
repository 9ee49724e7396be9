"""Spans and counters of the port's own stages, recorded in memory.

The recorder is off by default: :func:`enable` and :func:`disable` switch
it for the whole process.  Off, :func:`span` and :func:`call` return one
shared no-op context manager after a single flag check and :func:`count`
returns at once; nothing is recorded, no CUDA event is made and no
profiler range is opened.

On, every span records its name, its start and end on the host clock
(``time.perf_counter_ns``), its parent span and the id of the call it
belongs to:

* a **root** span is opened by :func:`call` (:func:`entry` on each public
  entry of the engine) and carries a fresh call id.  A public entry reached from inside
  another call (``run_batch`` through ``run_batch_async``, ``run_delta``
  through ``run_tiled``, the pipeline's rounds) opens nothing, so a call
  has one root;
* a **stage** span, :func:`span`, belongs to the call that is open around
  it; outside any call its call id is ``None``.  It is also opened as a
  ``torch.profiler.record_function("ph.<name>")`` range, which puts it on
  a device trace's own timeline beside the kernels and copies.  The root
  stays out of the profiler, so the innermost and outermost ranges open at
  any instant of a trace are stages.  A stage given a CUDA device also
  records a CUDA event on that device's current stream at its start and
  end: :meth:`Span.device_ms` is the stream's time between them, read
  only after the caller has synchronised.

The open span is a context variable, so spans of concurrent threads do
not nest into each other; :class:`repro_torch.ph.overlap.PendingResult`
runs ``resolve()`` in the context it was created in, so the stages a
harvest thread runs keep the call's id.

Counters (:func:`count`) are keyed by ``(counter, innermost open span)``.
The program keeps ``readbacks`` (:func:`readback`): every place its own
code blocks the host on the device; and, on ``run_delta``, the frame
store's kinds of call (``delta_full``, ``delta_partial``, ``delta_miss``)
and the real dirty tiles whose phases A+B re-ran (``delta_dirty_tiles``).
:func:`snapshot` returns the spans and counters held in memory;
:func:`reset` clears them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import threading
import time

import torch

__all__ = ["Span", "call", "count", "disable", "enable", "enabled", "entry",
           "readback", "reset", "snapshot", "span"]

PROFILER_PREFIX = "ph."

_on = False
_lock = threading.Lock()
_spans: list[Span] = []
_counters: dict[tuple[str, str | None], int] = {}
_ids = itertools.count(1)
_open: contextvars.ContextVar[_Open | None] = contextvars.ContextVar(
    "repro_torch_telemetry_span", default=None)


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span; times in nanoseconds of ``perf_counter_ns``."""

    name: str
    id: int
    parent: int | None      # the enclosing span's id; None for a root
    call: int | None        # the root's id; None outside any call
    t0_ns: int
    t1_ns: int
    events: tuple | None = None   # (start, end) CUDA events of a stage

    @property
    def root(self) -> bool:
        return self.parent is None and self.call == self.id

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def device_ms(self) -> float | None:
        """The stage's time on its CUDA stream, between its two events;
        ``None`` for a span without events.  The caller synchronises
        first."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


# The one context manager handed out while the recorder is off.
_NOOP = contextlib.nullcontext()


class _Open:
    """A span being recorded (the context variable's value)."""

    __slots__ = ("name", "id", "parent", "call", "device", "t0", "token",
                 "events", "range")

    def __init__(self, name: str, parent: _Open | None, root: bool,
                 device: torch.device | None):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        if root:
            self.call = self.id
        else:
            self.call = parent.call if parent is not None else None
        self.device = device if device is not None and \
            device.type == "cuda" else None
        self.range = None if root else torch.profiler.record_function(
            PROFILER_PREFIX + name)
        self.events = None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
            self.events = (start,)
        self.token = _open.set(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _open.reset(self.token)
        events = None
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            events = (self.events[0], end)
        if self.range is not None:
            self.range.__exit__(*exc)
        done = Span(self.name, self.id,
                    None if self.parent is None else self.parent.id,
                    self.call, self.t0, t1, events)
        with _lock:
            _spans.append(done)
        return False


def enable() -> None:
    """Start recording (spans and counters already held are kept)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def call(name: str):
    """The root span of one public entry, with a fresh call id; nothing
    when the recorder is off or a span is already open here."""
    if not _on or _open.get() is not None:
        return _NOOP
    return _Open(name, None, True, None)


def entry(fn):
    """Decorate a public entry: each call of ``fn`` is a :func:`call`
    named after it."""
    name = fn.__name__

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with call(name):
            return fn(*args, **kwargs)

    return traced


def span(name: str, device=None):
    """A stage span inside the open call.  ``device``: where the stage
    runs; a CUDA device adds the stage's two events."""
    if not _on:
        return _NOOP
    return _Open(name, _open.get(), False,
                 None if device is None else torch.device(device))


def count(counter: str, n: int = 1) -> None:
    """Add ``n`` to ``counter`` under the innermost open span."""
    if not _on:
        return
    cur = _open.get()
    key = (counter, None if cur is None else cur.name)
    with _lock:
        _counters[key] = _counters.get(key, 0) + n


def readback(device=None) -> None:
    """Count one ``readbacks``: a place where the host waits on the
    device.  A site whose data may lie on either side (a check of the
    caller's input, an upload, a copy to the host) passes that data's
    device and counts only on a CUDA device; a read of the computation's
    own results passes nothing and counts on any device, so a run on the
    host counts the reads a run on the card makes."""
    if _on and (device is None or torch.device(device).type == "cuda"):
        count("readbacks")


def snapshot() -> dict:
    """``{"spans": [Span, ...], "counters": {(counter, span): n}}``,
    copies of what is held in memory."""
    with _lock:
        return {"spans": list(_spans), "counters": dict(_counters)}


def reset() -> None:
    """Drop every span and counter held."""
    with _lock:
        _spans.clear()
        _counters.clear()

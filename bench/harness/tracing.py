"""Spans, launch probes and one profiled slice of the window.

Only a ``--trace 1`` run builds a :class:`Tracer`.  Each per-layer
metric module may define ``install(tracer, engine)`` to put the spans or
probes it reads around calls into the program; the wrappers are the
benchmark's and come off again when the run ends.  ``torch.profiler``
records a few steady calls (``trace_calls`` of the mix, from the window's
second call on), so the trace stays small.  Every call of the window
also gets the process's system CPU time counted across it (``sys_s``,
by call index, in seconds).
"""
from __future__ import annotations

import contextlib
import json
import os
import resource
import tempfile
import time

import harness.trace_slice as trace_slice


class Tracer:
    def __init__(self, device, slice_calls: range):
        self.device = device
        self.slice_calls = slice_calls
        self.call_index = -1
        self.spans: list[tuple[str, int, float, float]] = []
        self.launches: dict[str, list] = {}
        self.sys_s: dict[int, float] = {}
        self.trace = None
        self._prof = None
        self._profiling = False
        self._undo: list = []

    # -- wrappers ----------------------------------------------------------

    def span_method(self, obj, attr: str, name: str) -> None:
        """Record a host span ``name`` around every call of ``obj.attr``
        (an instance attribute shadows the method until :meth:`close`)."""
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with self._annotate(f"bench.{name}"):
                out = inner(*args, **kwargs)
            self.spans.append((name, self.call_index, t0,
                               time.perf_counter()))
            return out

        setattr(obj, attr, wrapped)
        self._undo.append(lambda: delattr(obj, attr)
                          if attr in vars(obj) else None)

    def probe_function(self, module, attr: str, name: str, recorder
                       ) -> None:
        """While the slice is profiled, ``recorder(args, kwargs)`` notes
        each call of ``module.attr`` (a launch's arguments) into
        ``launches[name]``.  Device work it starts runs under a
        ``bench.probe`` range, which the trace reduction leaves out."""
        inner = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if self._profiling:
                with self._annotate("bench.probe"):
                    self.launches.setdefault(name, []).append(
                        recorder(args, kwargs))
            return inner(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._undo.append(lambda: setattr(module, attr, inner))

    def close(self) -> None:
        self._stop()
        while self._undo:
            self._undo.pop()()

    # -- the profiled slice ------------------------------------------------

    def _annotate(self, name: str):
        if not self._profiling:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def call(self, i: int):
        """Around call ``i`` of the window."""
        self.call_index = i
        if i == self.slice_calls.start:
            self._start()
        s0 = _system_seconds()
        with self._annotate("bench.call"):
            yield
        self.sys_s[i] = _system_seconds() - s0
        if self._profiling and i == self.slice_calls.stop - 1:
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._profiling = True

    def _stop(self) -> None:
        if not self._profiling:
            return
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiling = False
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.trace = trace_slice.TraceSlice(events)


def _system_seconds() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_stime

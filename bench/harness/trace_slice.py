"""Reduce a ``torch.profiler`` chrome trace of the profiled slice to
device busy time, per-kernel time, host syncs and idle gaps.

The slice is the span of the benchmark's ``bench.call`` ranges, less the
device time of the benchmark's own probes (the kernels whose launch lies
in a ``bench.probe`` range): that time is neither busy nor idle.  Device
work is every other kernel, copy and set on the card inside the span.
Busy time is the union of those intervals, so overlapping streams count
once.
"""
from __future__ import annotations

import heapq
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
_LIBRARY_MARKERS = ("at::", "cub::", "at_cuda_detail", "cutlass", "cublas",
                    "nccl")


def port_kernel_names(root: Path) -> dict[str, str]:
    """Each ``__global__`` function of the program's CUDA sources, mapped
    to its kernel directory (``src/repro_torch/kernels/<dir>/csrc``)."""
    names = {}
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__"
                     r"\((?:[^()]|\([^()]*\))*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    for cu in sorted(root.glob("src/repro_torch/kernels/*/csrc/*.cu")):
        for name in pat.findall(cu.read_text()):
            names[name] = cu.parent.parent.name
    return names


def _ends(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def union_length(intervals) -> float:
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


class TraceSlice:
    """Times in microseconds on the trace's clock."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        calls = [_ends(e) for e in xs if e.get("cat") == "user_annotation"
                 and e.get("name") == "bench.call"]
        self.calls = len(calls)
        self.start = min((a for a, _ in calls), default=0.0)
        self.end = max((b for _, b in calls), default=0.0)
        probes = [_ends(e) for e in xs if e.get("cat") == "user_annotation"
                  and e.get("name") == "bench.probe"]
        self.runtime = [e for e in xs if e.get("cat") in
                        ("cuda_runtime", "cuda_driver")
                        and self.start <= float(e["ts"]) <= self.end]
        probe_corr = {e.get("args", {}).get("correlation")
                      for e in self.runtime
                      if any(a <= float(e["ts"]) <= b for a, b in probes)}
        probe_corr.discard(None)
        self.device, self.probes = [], []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            a, b = _ends(e)
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if e.get("args", {}).get("correlation") in probe_corr:
                self.probes.append((a, b))
            else:
                self.device.append((a, b, e["name"], e["cat"]))
        self.host = [(*_ends(e), e["name"]) for e in xs
                     if e.get("cat") in ("cpu_op", "user_annotation",
                                         "cuda_runtime")
                     and e.get("name") != "bench.call"
                     and self.start <= float(e["ts"]) <= self.end]

    @property
    def window_us(self) -> float:
        return self.end - self.start - union_length(self.probes)

    def busy_us(self) -> float:
        return union_length((a, b) for a, b, _, _ in self.device)

    def kernels(self):
        return [(a, b, n) for a, b, n, c in self.device if c == "kernel"]

    def library_of(self, name: str, names: dict[str, str]) -> str | None:
        """The program's kernel directory that launched kernel ``name``,
        or None for a kernel of PyTorch or another library."""
        if any(m in name for m in _LIBRARY_MARKERS):
            return None
        for fn, lib in names.items():
            if re.search(rf"\b{re.escape(fn)}\b", name):
                return lib
        return None

    def sync_count(self) -> int:
        return sum(1 for e in self.runtime if e["name"] in SYNC_CALLS)

    def top_device_ops(self, k: int = 10):
        by: dict[str, float] = {}
        for a, b, n, _ in self.device:
            by[n] = by.get(n, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], us * 1e-6] for n, us in top]

    def idle_gaps(self, k: int = 10):
        """Device idle time inside the slice, summed by what the host was
        doing at each gap's middle: the outermost and innermost host
        ranges there (``outer > inner``), or ``python`` where none.  The
        probes' device time is no gap."""
        spans = sorted([(a, b) for a, b, _, _ in self.device]
                       + self.probes)
        gaps, cursor = [], self.start
        for a, b in spans:
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if self.end > cursor:
            gaps.append((cursor, self.end))
        # Sweep the gaps' middles in order over the host ranges open there.
        host = sorted(self.host)
        active: list = []
        j = 0
        by: dict[str, float] = {}
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while j < len(host) and host[j][0] <= mid:
                heapq.heappush(active, (host[j][1], host[j][0], host[j][2]))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            around = sorted((he - ha, n) for he, ha, n in active)
            if not around:
                name = "python"
            elif len(around) == 1:
                name = around[0][1]
            else:
                name = f"{around[-1][1]} > {around[0][1]}"
            by[name[:160]] = by.get(name[:160], 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us * 1e-6] for n, us in top]

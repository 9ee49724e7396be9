"""90th percentile of every call's latency in the window, from the call's
start to its last diagram in host memory (failed calls count as the
longest)."""
from harness.stats import percentile


def read(run):
    if not run.calls:
        return None
    lat = [float("inf") if c.failed else c.t1 - c.t0 for c in run.calls]
    return percentile(lat, 90) * 1e3

"""Share of the profiled slice in which no kernel, copy or set ran on the
card: 1 - (union of device intervals) / (the slice's span)."""


def read(run):
    tr = run.tracer.trace
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)

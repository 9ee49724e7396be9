"""Blocking host waits per call in the profiled slice: the
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``cudaEventSynchronize`` runtime calls (phase B's doublings, phase C's
Boruvka rounds, the result copies)."""


def read(run):
    tr = run.tracer.trace
    if tr is None or not tr.device or not tr.calls:
        return None
    return tr.sync_count() / tr.calls

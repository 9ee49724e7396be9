"""Device time of every kernel in the profiled slice that none of the
program's hand-written CUDA libraries launched (PyTorch's own kernels:
the core stages written in torch ops), per frame of the slice."""
from harness.trace_slice import port_kernel_names


def read(run):
    tr = run.tracer.trace
    if tr is None or not tr.kernels():
        return None
    names = port_kernel_names(run.root)
    us = sum(b - a for a, b, n in tr.kernels()
             if tr.library_of(n, names) is None)
    return us * 1e-3 / run.slice_frames()

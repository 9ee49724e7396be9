"""The best-edge kernel's share of its memory roofline in the profiled
slice: each launch's least traffic ``8·E + 8·live + 12·nv`` bytes (int64
keys; E keys, the live edges' int32 endpoints, the nv-entry table) at the
H100's 3.35 TB/s, over the device time of the kernels of
``kernels/ph_phase_c``.  ``live`` is counted on the card from the
launch's own keys (a key above the dtype's minimum, the kernel's pad), in
a probe range the trace leaves out."""
import harness.roofline as roofline
from harness.trace_slice import port_kernel_names

LIBRARY = "ph_phase_c"


def install(tracer, engine):
    import torch
    from repro_torch.kernels.ph_phase_c import kernel

    def record(args, kwargs):
        key, nv = args[0], int(args[3])
        live = (key != torch.iinfo(key.dtype).min).sum()
        return (key.numel(), key.element_size(), live, nv)

    tracer.probe_function(kernel, "best_edge_reduce", LIBRARY, record)


def read(run):
    tr = run.tracer.trace
    launches = run.tracer.launches.get(LIBRARY)
    if tr is None or not launches:
        return None
    names = port_kernel_names(run.root)
    us = sum(b - a for a, b, n in tr.kernels()
             if tr.library_of(n, names) == LIBRARY)
    if us <= 0:
        return None
    total = sum(roofline.best_edge_bytes(e, kb, int(live), nv)
                for e, kb, live, nv in launches)
    return 100.0 * roofline.bound_seconds(total) / (us * 1e-6)

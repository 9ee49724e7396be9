"""The fused phase-A kernel's share of its memory roofline in the profiled
slice: each launch's least traffic ``n·(itemsize + 8)`` bytes (from the
image it was given) at the H100's 3.35 TB/s, over the device time of the
kernels of ``kernels/ph_phase_a``."""
import harness.roofline as roofline
from harness.trace_slice import port_kernel_names

LIBRARY = "ph_phase_a"


def install(tracer, engine):
    from repro_torch.kernels.ph_phase_a import kernel

    def record(args, kwargs):
        image = args[0]
        return roofline.phase_a_bytes(image.numel(), image.element_size())

    tracer.probe_function(kernel, "phase_a", LIBRARY, record)


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
    return 100.0 * roofline.bound_seconds(sum(launches)) / (us * 1e-6)

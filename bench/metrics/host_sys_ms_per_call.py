"""System CPU time of the benchmark's process across a call (all its
threads, ``getrusage(RUSAGE_SELF).ru_stime``), averaged over the
window's calls outside the profiled slice (the profiler's own buffers
cost there).  Most of it is the OS mapping and zeroing host memory that
a call touches for the first time, such as fresh large temporaries and
the diagrams' host copies.  The counter has the OS's tick (10 ms), so
only the mean over many calls resolves."""


def read(run):
    sl = run.tracer.slice_calls
    per = [s for i, s in run.tracer.sys_s.items() if i not in sl]
    if not per:
        return None
    return 1e3 * sum(per) / len(per)

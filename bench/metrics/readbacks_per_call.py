"""Places per call where the program's own code blocked the host on the
device: the ``readbacks`` counter of ``repro_torch.telemetry`` (each
``.item()``/``.tolist()``/``bool()``/``int()`` of a device tensor, each
blocking copy to the host and each pageable upload, under whichever
stage span it waited in), summed over the window's calls and divided by
their number.  The benchmark's own copies of the results are not the
program's and are not counted.  The recorder is on from the window's
start to the run's end; a program without it reads nothing."""


def install(tracer, engine):
    try:
        from repro_torch import telemetry
    except ImportError:
        return
    telemetry.reset()
    telemetry.enable()
    tracer._undo.append(telemetry.disable)


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    if not run.calls:
        return None
    total = sum(n for (name, _), n in telemetry.snapshot()["counters"].items()
                if name == "readbacks")
    return total / len(run.calls)

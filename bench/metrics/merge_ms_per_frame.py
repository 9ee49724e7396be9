"""Device time of the elder-rule merge per frame: the whole-image path's
``phase_c`` spans and the tiled path's ``tiles.seam_merge`` spans of
``repro_torch.telemetry``, each timed by the CUDA events it records on
its stream at its start and end (its kernels, the best-edge kernel's
included, and the stream's waits on each Boruvka round's readbacks),
summed over the window's calls and divided by their frames.  Nothing on
the CPU, where a span has no events, or from a program without the
recorder."""

STAGES = ("phase_c", "tiles.seam_merge")


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
    spans = [s for s in telemetry.snapshot()["spans"] if s.name in STAGES]
    frames = sum(c.frames for c in run.calls)
    if not spans or not frames or any(s.events is None for s in spans):
        return None
    return sum(s.device_ms() for s in spans) / frames

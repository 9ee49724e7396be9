"""Host time of the delta path's tile hash and frame-store traffic per
frame: the ``delta.hash`` spans (the halo-padded host copy of the frame
through every tile's digest) and the ``delta.lookup`` spans (the frame
store's lookup and put) of ``repro_torch.telemetry``, summed over the
window's calls and divided by their frames.  The recorder is on from the
window's start to the run's end; a program without these spans reads
nothing."""

NAMES = ("delta.hash", "delta.lookup")


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
    spans = [s for s in telemetry.snapshot()["spans"]
             if s.name in NAMES and s.call is not None]
    frames = sum(c.frames for c in run.calls)
    if not spans or not frames:
        return None
    return sum(s.host_ms for s in spans) / frames

"""Host time of the delta path's dirty staging per frame: the
``delta.stage`` spans of ``repro_torch.telemetry`` (the dirty tiles'
halo windows cut from a padded host copy of the frame, stacked and
uploaded, and their index stack), summed over the window's calls and
divided by their frames.  The recorder is on from the window's start to
the run's end; a program without the span reads nothing."""


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
             if s.name == "delta.stage" and s.call is not None]
    frames = sum(c.frames for c in run.calls)
    if not spans or not frames:
        return None
    return sum(s.host_ms for s in spans) / frames

"""Host time of the program's own input preparation per frame: the
``prep`` spans of ``repro_torch.telemetry`` (the dtype policy with
``check_finite``, the staging copy and the upload's enqueue), summed
over the window's calls and divided by their frames.  The recorder is on
from the window's start to the run's end; a program without it reads
nothing."""


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
             if s.name == "prep" and s.call is not None]
    frames = sum(c.frames for c in run.calls)
    if not spans or not frames:
        return None
    return sum(s.host_ms for s in spans) / frames

"""Device time of the tiled path's per-tile phases A+B per frame: each
``tiles.phase_ab`` span of ``repro_torch.telemetry`` timed by the CUDA
events it records on its stream at its start and end (its kernels and
the stream's waits on the stage's own readbacks), summed over the
window's calls and divided by their frames.  Nothing on the CPU, where a
span has no events, or from a program without the recorder."""


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
             if s.name == "tiles.phase_ab"]
    frames = sum(c.frames for c in run.calls)
    if not spans or not frames or any(s.events is None for s in spans):
        return None
    return sum(s.device_ms() for s in spans) / frames

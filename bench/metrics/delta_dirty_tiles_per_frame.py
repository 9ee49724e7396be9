"""Tiles whose phases A+B the delta path re-ran per frame: the
``delta_dirty_tiles`` counter of ``repro_torch.telemetry`` (real dirty
tiles only, not the padding rows of the power-of-two stack), summed over
the window's calls and divided by their frames.  A frame store that
matches each realisation against the base reads the recipe's dirty count
(5.0 for 5 of 100 tiles); a miss reads every tile, a full hit none.  The
recorder is on from the window's start to the run's end; a program
without the counter reads nothing."""


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
    counters = telemetry.snapshot()["counters"]
    kinds = {name for name, _ in counters}
    frames = sum(c.frames for c in run.calls)
    if not frames or not kinds & {"delta_full", "delta_partial",
                                  "delta_miss"}:
        return None
    return sum(n for (name, _), n in counters.items()
               if name == "delta_dirty_tiles") / frames

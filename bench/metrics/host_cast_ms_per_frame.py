"""Host time of the engine's input preparation per frame: for each call,
from the start of ``PHEngine.cast_input(_host)`` (dtype policy,
``check_finite``) to the end of the staging upload's enqueue
(``StagingPool.upload``) or of ``cast_input``'s own upload, summed over
the window's calls and divided by their frames."""

NAMES = ("prep.cast_input_host", "prep.cast_input", "prep.upload")


def install(tracer, engine):
    tracer.span_method(engine, "cast_input_host", NAMES[0])
    tracer.span_method(engine, "cast_input", NAMES[1])
    tracer.span_method(engine.staging, "upload", NAMES[2])


def read(run):
    by_call: dict[int, list] = {}
    for name, i, t0, t1 in run.tracer.spans:
        if name in NAMES and i >= 0:
            lo, hi = by_call.get(i, (t0, t1))
            by_call[i] = (min(lo, t0), max(hi, t1))
    if not by_call:
        return None
    frames = sum(run.calls[i].frames for i in by_call)
    return sum(hi - lo for lo, hi in by_call.values()) * 1e3 / frames

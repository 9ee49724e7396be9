"""Input megapixels of every frame whose diagram reached host memory, over
the whole window (first call's start to the last call's end)."""


def read(run):
    done = [c for c in run.calls if not c.failed]
    span = run.calls[-1].t1 - run.calls[0].t0
    return sum(c.pixels for c in done) / 1e6 / span if done else None

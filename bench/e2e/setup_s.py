"""Seconds from the process's start to the window: imports, the frame
pool drawn on the card, thresholds, the engine, the kernels' build or
load, and the warm pass over the pool."""


def read(run):
    return run.setup_s

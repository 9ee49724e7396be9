"""Entry: ``PHEngine.run_delta`` of one host frame a call against the
engine's frame store, with the threshold the mix gives."""
from __future__ import annotations

import harness.ph_engine as ph
from harness.ph_engine import build  # noqa: F401  (the driver's builder)


def call(engine, frames, thresholds):
    """``frames``: a (1, H, W) host array; returns ``(host diagram,
    regrow attempts)``."""
    if frames.shape[0] != 1:
        raise ValueError("run_delta takes one frame a call")
    t = None if thresholds is None else thresholds[0]
    res = engine.run_delta(frames[0], truncate_value=t)
    return ph.host_diagram(res.diagram), res.regrow.attempts

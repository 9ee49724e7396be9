"""Entry: ``PHEngine.run_batch`` of a uniform (B, H, W) host array a call,
``dedupe=False`` (survey exposures are distinct), with the thresholds the
mix gives (None: the vanilla diagrams)."""
from __future__ import annotations

import harness.ph_engine as ph
from harness.ph_engine import build  # noqa: F401  (the driver's builder)


def call(engine, frames, thresholds):
    res = engine.run_batch(frames, thresholds, dedupe=False)
    return ph.host_diagram(res.diagram), res.regrow.attempts

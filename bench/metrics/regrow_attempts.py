"""Overflow re-dispatches (``PHResult.regrow.attempts``) summed over the
window's calls, plus the plan builds the engine's ``plan_stats()``
gained in the window.  Zero once the warm pass settled the sticky
memo; anything else is work a call repeats."""


def read(run):
    return float(sum(c.regrows for c in run.calls) + run.plan_builds)

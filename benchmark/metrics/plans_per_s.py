"""Converged, not given up and collision-free plans completed in the
window, over the window's seconds (host clock; the window closes when
the last request started in it completes)."""


def read(run):
    return sum(r["good"] for r in run.requests) / run.window_s

"""Share of the traced window in which no operation runs on the device:
the union of the profiler's device intervals (the single-plan cell, moving plan_p95_ms)."""

from benchmark import trace


def read(run):
    return trace.idle_pct(run)

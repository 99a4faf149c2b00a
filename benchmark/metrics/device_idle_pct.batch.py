"""Share of the traced window in which no operation runs on the device:
the union of the profiler's device intervals (batch cells, moving plans_per_s)."""

from benchmark import trace


def read(run):
    return trace.idle_pct(run)

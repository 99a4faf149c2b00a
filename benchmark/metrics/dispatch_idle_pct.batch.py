"""Share of the traced window in which the device runs nothing while the
host is inside an optimizer attempt span and outside its stop test: the
idle time the host's dispatch of an attempt causes (batch cells, moving
plans_per_s)."""

from benchmark import spans


def read(run):
    return spans.dispatch_idle_pct(run)

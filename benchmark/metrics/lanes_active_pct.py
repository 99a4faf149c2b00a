"""Lanes active at the optimizer's stop tests over the lanes the attempts
run (B x attempts), over the traced window's plan_batch calls, in
percent: the program's counts on its plan_batch spans."""

from benchmark import spans


def read(run):
    return spans.lanes_active_pct(run)

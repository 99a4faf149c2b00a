"""The program's stop-test spans (the optimizer's one host sync an
attempt) over its plan_batch spans in the traced window, in percent: the
share of a call in which the host waits on the device."""

from benchmark import spans


def read(run):
    return spans.stop_test_wait_pct(run)

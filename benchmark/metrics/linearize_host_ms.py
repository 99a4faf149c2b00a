"""Mean host milliseconds of the program's linearize spans inside the
traced window's plan_batch calls: the host side of the linearize that
linearize_ms gives the device side of."""

from benchmark import spans


def read(run):
    return spans.linearize_host_ms(run)

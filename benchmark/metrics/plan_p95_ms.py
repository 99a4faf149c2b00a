"""95th percentile of the window's request latencies, each from the start
of make_problem to the host copy of the result (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile([r["latency_s"] for r in run.requests], 95)) * 1e3

"""Mean of the result's `iterations` column (accepted LM steps) over the
window's plans: a count the program reports."""

import numpy as np


def read(run):
    return float(np.mean(np.concatenate([r["iterations"] for r in run.requests])))

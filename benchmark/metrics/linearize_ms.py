"""Device milliseconds of one traj_linearize (planner/problem.py) at the
cell's batch on its first request's straight-line init: after one warm
call, 10 calls under the profiler, and the union of the device
operations' intervals between the first call's start and the end of the
last, over 10. None off the card."""

import time


def read(run):
    from gpmp2_tpu_torch.planner import traj_linearize

    from benchmark import trace

    if run.device.type != "cuda":
        return None
    probs, init = run.loop.first_problems()
    traj_linearize(probs, init)
    run.sync()
    prof = trace.start(run.device)
    t0 = time.time_ns()
    for _ in range(10):
        traj_linearize(probs, init)
    run.sync()
    t1 = time.time_ns()
    prof.stop()
    return trace.busy_s(trace.device_ops(prof, run.device, t0, t1)) * 1e3 / 10

#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one NVIDIA GPU.

    python3 tools/profile_torch_main.py [--out DIR]

Builds chip_smoke.py's main-path inputs (`main_path_inputs`: WAM 7-DOF, the
300^3 WAMDeskDataset SDF in float32, numpy seed 0 endpoints, LM with
max_iter 50 and rel_thresh 1e-2) and, for B = 2048, 32 and 1, prints one
JSON line:

- linearize_ms, solve_ms: CUDA-event means of one `traj_linearize` of the
  straight-line init, and of one damped K1 solve of that linearization;
- plan_wall_ms: host clock around one warm `plan_batch` that ends in
  `torch.cuda.synchronize()`;
- profiled_wall_ms: the same, for the one `plan_batch` run under
  torch.profiler (the profiler's host overhead is included);
- device_busy_ms: the summed device time of every CUDA kernel event in
  that profiled run. device_busy_ms / profiled_wall_ms is the device's
  busy share;
- kernel_events: the number of CUDA kernel events in the profiled run;
- max_iterations: the largest per-lane iteration count of the solve;
- k1_launches: K1 launches in the profiled run, one per LM attempt.

The per-op table of each profiled run, sorted by self CUDA time, goes to
DIR/profile_b{B}.txt (default DIR: build/profile). Imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_main: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from gpmp2_tpu_torch import _build
    from gpmp2_tpu_torch.ops.btsolve import (batched_block_tridiag_solve,
                                             block_tridiag_solve_cuda)
    from gpmp2_tpu_torch.planner import (init_traj_straight_line, make_problem,
                                         plan_batch, traj_linearize)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.kernels_lib()

    dev = torch.device("cuda", 0)
    robot, sdf, setting, params, starts, goals = cs.main_path_inputs(dev)
    os.makedirs(args.out, exist_ok=True)

    for b in (cs.B_MAIN, 32, 1):
        z = torch.zeros_like(starts[:b])
        probs = make_problem(robot, sdf, starts[:b], z, goals[:b], z, setting)
        init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                       setting.total_step, setting.total_time)
        plan_batch(probs, init, params)  # warm-up
        torch.cuda.synchronize()
        lin = traj_linearize(probs, init)
        linearize_ms = cs.cuda_ms(lambda: traj_linearize(probs, init), 10)
        lam = torch.full((b,), 100.0, dtype=torch.float32, device=dev)
        solve_ms = cs.cuda_ms(
            lambda: batched_block_tridiag_solve(lin[0], lin[1], lin[2], lam=lam), 20)

        t0 = time.perf_counter()
        plan_batch(probs, init, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

        block_tridiag_solve_cuda.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = plan_batch(probs, init, params)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        k1_launches = block_tridiag_solve_cuda.launches
        ka = prof.key_averages()
        # operator rows repeat their kernels' time, so count kernel rows only
        kernels = [e for e in ka if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0]
        print(json.dumps({
            "B": b, "card": card,
            "linearize_ms": linearize_ms, "solve_ms": solve_ms,
            "plan_wall_ms": wall * 1e3, "profiled_wall_ms": pwall * 1e3,
            "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernel_events": sum(e.count for e in kernels),
            "max_iterations": int(res.iterations.max()), "k1_launches": k1_launches,
        }), flush=True)
        table = ka.table(sort_by="self_cuda_time_total", row_limit=25)
        with open(os.path.join(args.out, f"profile_b{b}.txt"), "w") as fh:
            fh.write(card + "\n" + table)
        print("\n".join(table.splitlines()[: 30 if b == cs.B_MAIN else 14]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

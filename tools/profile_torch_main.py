#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one NVIDIA GPU.

    python3 tools/profile_torch_main.py [--out DIR]
        [--config main|mobile|pr2|replan|longhorizon]

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

`--config mobile` profiles one MobileBaseSE2 solve instead (chip_smoke.py's
suite config: MobileMap1, SE(2) states, vehicle dynamics, B = 4096, the
suite's throughput draws, LM, float32), and `--config pr2` one solve of
chip_smoke.py's PR2 row (phase 10: 18 dof, 65 spheres, the 300^3 field,
self-collision, B = 2048). Each prints the same fields plus the share of
labelled stages (planner/problem.py): ranges_ms, the device time under
each labelled range in the profiled solve (spans_ms: each range's span on
the card's timeline, idle gaps included; both are left out of
device_busy_ms); jacobian_device_ms, the sum over the boundary-prior, Lie
GP prior and interpolation Jacobians; for pr2 also the obstacle sphere
pass (centres and Jacobians), the lookup and -g . J, the interpolated
factors' Gram and the self-collision factors. jacobian_ms / linearize_ms
are CUDA-event means of those Jacobians alone and of one whole
`traj_linearize`, on the straight-line init. The table goes to
DIR/profile_{mobile,pr2}_b{B}.txt.

`--config replan` profiles one warm round of chip_smoke.py's WAM
replanning fleet (phase 11: B = 1024 sessions, warm updates of 3 steps),
after the cold update and three rounds: round_wall_ms (host clock, not
profiled) and profiled_wall_ms of the round, its device busy time and
kernel events, update_ms and update_device_ms (the host span of the
round's `update` and the device time under it; the rest of the round is
the slot and goal writes), linearize_ms (CUDA events, one
`traj_linearize` of the fleet at its estimate) and K1's launches. The
table goes to DIR/profile_replan_b1024.txt.

`--config longhorizon` profiles chip_smoke.py's phase-14 solves
(`bench_longhorizon.py`'s systems: B = 256, m = 14, float32, numpy seed
0, n = 65, 129, 257, 1025): for K1 and the partitioned solve at each n,
one JSON line with busy_ms and k1_ms, the summed device time of all
kernels and of K1's per solve over 5 solves, kernels_per_solve, and
top, the five kernels that take the most of it (name, ms per solve).
All solves run in one profiled window, a marker kernel
(torch.cuda._sleep) before each solver's and after the last; the profiler
can hand a window's last records to a later window (seen on the H100),
so short windows after it collect what arrives late, and each solver's
records are those between its two markers. Missing markers or K1
records raise. The lines also go to DIR/profile_longhorizon.txt.
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
    ap.add_argument("--config", choices=("main", "mobile", "pr2", "replan", "longhorizon"),
                    default="main")
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
    from gpmp2_tpu_torch.ops.btsolve import batched_block_tridiag_solve
    from gpmp2_tpu_torch.planner import (init_traj_straight_line, make_problem,
                                         plan_batch, traj_linearize)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.kernels_lib()

    dev = torch.device("cuda", 0)
    os.makedirs(args.out, exist_ok=True)
    if args.config == "replan":
        return profile_replan(args.out, card, dev)
    if args.config == "longhorizon":
        return profile_longhorizon(args.out, card, dev)
    if args.config != "main":
        return profile_mobile(args.out, card, dev, args.config)
    robot, sdf, setting, params, starts, goals = cs.main_path_inputs(dev)

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

        cs.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = plan_batch(probs, init, params)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        k1_launches = cs.read_launches()["btsolve"]
        ka = prof.key_averages()
        print(json.dumps({
            "B": b, "card": card,
            "linearize_ms": linearize_ms, "solve_ms": solve_ms,
            "plan_wall_ms": wall * 1e3, "profiled_wall_ms": pwall * 1e3,
            **device_busy(ka),
            "max_iterations": int(res.iterations.max()), "k1_launches": k1_launches,
        }), flush=True)
        table = ka.table(sort_by="self_cuda_time_total", row_limit=25)
        with open(os.path.join(args.out, f"profile_b{b}.txt"), "w") as fh:
            fh.write(card + "\n" + table)
        print("\n".join(table.splitlines()[: 30 if b == cs.B_MAIN else 14]), flush=True)
    return 0


def device_busy(ka):
    """Summed device time and count of the CUDA kernel events of a
    profile's key averages (operator rows repeat their kernels' time, so
    kernel rows only)."""
    kernels = [e for e in ka if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    return {"device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernel_events": sum(e.count for e in kernels)}


JACOBIANS = ("_prior_pose_jacobian", "_lie_gp_jacobians", "_interp_pose_jacobians")
# the PR2 linearize's other labelled stages: the obstacle sphere pass
# (centres and Jacobians), the SDF lookup and -g . J, the interpolated
# factors' Gram, the self-collision factors
PR2_STAGES = ("_spheres_and_jac", "_obs_res_and_jac", "_interp_gram", "_selfcoll_res_and_jac")


def mobile_problem(dev):
    """chip_smoke.py's MobileBaseSE2 suite config at B = 4096 on the suite's
    throughput draws: (problems, initial trajectory, LM parameters)."""
    import torch

    import chip_smoke as cs
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting
    from gpmp2_tpu_torch.robots import generate_mobile_base

    B = cs.SUITE_BATCH["MobileBaseSE2"]
    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    setting = cs.mobile_setting()
    # the suite's throughput draws: numpy seed 1 after PointRobot2D's four
    # uniform draws of its batch
    rng = np.random.default_rng(1)
    rng.uniform(size=4 * cs.SUITE_BATCH["PointRobot2D"])
    s, g = (torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in cs.draw_mobile(rng, B))
    z = torch.zeros_like(s)
    probs = make_problem(generate_mobile_base(device=dev), sdf, s, z, g, z, setting,
                         **cs.MOBILE_KW)
    init = init_traj_straight_line(probs.space, s, g, setting.total_step, setting.total_time)
    return probs, init, optimizer_params_from_setting(setting)


def pr2_problem(dev):
    """chip_smoke.py's PR2 row at B = 2048 (phase 10): (problems, initial
    trajectory, LM parameters)."""
    import torch

    import chip_smoke as cs
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting

    sdf = cs.main_path_inputs(dev)[1]
    robot, s, g = cs.pr2_inputs(dev, sdf)
    setting = cs.pr2_setting()
    z = torch.zeros_like(s)
    probs = make_problem(robot, sdf, s, z, g, z, setting, **cs.PR2_KW)
    init = init_traj_straight_line(probs.space, s, g, setting.total_step, setting.total_time)
    return probs, init, optimizer_params_from_setting(setting)


def profile_mobile(out, card, dev, config):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs
    from gpmp2_tpu_torch.planner import plan_batch, traj_linearize
    from gpmp2_tpu_torch.planner import problem as problem_mod

    probs, init, params = (pr2_problem if config == "pr2" else mobile_problem)(dev)
    labels = JACOBIANS + (PR2_STAGES if config == "pr2" else ())
    plan_batch(probs, init, params)  # warm-up
    torch.cuda.synchronize()

    pose, vel = init
    B, n, d = pose.shape
    T = probs.taus.shape[0]
    pt0 = problem_mod._collision_confs(probs, pose, vel)[:, n:].reshape(B, n - 1, T, d)

    def jacobians():
        problem_mod._prior_pose_jacobian(probs.space, probs.start_pose, pose[:, 0])
        problem_mod._prior_pose_jacobian(probs.space, probs.end_pose, pose[:, -1])
        problem_mod._lie_gp_jacobians(probs, pose, vel)
        problem_mod._interp_pose_jacobians(probs, pose, vel, pt0)

    linearize_ms = cs.cuda_ms(lambda: traj_linearize(probs, init), 10)
    jacobian_ms = cs.cuda_ms(jacobians, 10)

    # label the stages for the profiled solve; a helper that calls itself
    # (the SE(2) x R^n Jacobians call their SE(2) block) is labelled once
    originals = {name: getattr(problem_mod, name) for name in labels}
    depth = dict.fromkeys(labels, 0)

    def labelled(name, fn):
        def run(*a, **k):
            if depth[name]:
                return fn(*a, **k)
            depth[name] += 1
            try:
                with record_function(name):
                    return fn(*a, **k)
            finally:
                depth[name] -= 1
        return run

    for name, fn in originals.items():
        setattr(problem_mod, name, labelled(name, fn))
    cs.reset_launches()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = plan_batch(probs, init, params)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(problem_mod, name, fn)
    ka = prof.key_averages()
    # a labelled range has a host row (its kernels' device time) and a
    # device row (its span on the card's timeline, gaps included)
    ranges = {e.key: e.device_time_total / 1e3 for e in ka
              if e.key in labels and e.device_type.name == "CPU"}
    spans = {e.key: e.self_device_time_total / 1e3 for e in ka
             if e.key in labels and e.device_type.name == "CUDA"}
    print(json.dumps({
        "config": "PR2" if config == "pr2" else "MobileBaseSE2", "B": B, "card": card,
        "linearize_ms": linearize_ms, "jacobian_ms": jacobian_ms,
        "profiled_wall_ms": pwall * 1e3,
        **device_busy([e for e in ka if e.key not in labels]),
        "jacobian_device_ms": sum(ranges.get(k, 0.0) for k in JACOBIANS),
        "ranges_ms": ranges, "spans_ms": spans,
        "max_iterations": int(res.iterations.max()),
        "k1_launches": cs.read_launches()["btsolve"],
    }), flush=True)
    table = ka.table(sort_by="self_cuda_time_total", row_limit=30)
    with open(os.path.join(out, f"profile_{config}_b{B}.txt"), "w") as fh:
        fh.write(card + "\n" + table)
    print("\n".join(table.splitlines()[:34]), flush=True)
    return 0


def profile_replan(out, card, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke as cs
    from gpmp2_tpu_torch.planner import traj_linearize

    fleet, one_round = cs.wam_fleet_sessions(dev, cs.main_path_inputs(dev))
    fleet.update()
    for r in range(3):
        one_round(r)
    linearize_ms = cs.cuda_ms(lambda: traj_linearize(fleet.problems, fleet.values()), 10)
    t0 = time.perf_counter()
    one_round(3)
    wall = time.perf_counter() - t0

    update = fleet.update

    def labelled_update():
        with record_function("update"):
            return update()

    fleet.update = labelled_update
    cs.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, _, _ = one_round(4)
        pwall = time.perf_counter() - t0
    ka = prof.key_averages()
    row = next(e for e in ka if e.key == "update" and e.device_type.name == "CPU")
    print(json.dumps({
        "config": "replan", "B": cs.B_FLEET, "card": card, "linearize_ms": linearize_ms,
        "round_wall_ms": wall * 1e3, "profiled_wall_ms": pwall * 1e3,
        **device_busy([e for e in ka if e.key != "update"]),
        "update_ms": row.cpu_time_total / 1e3, "update_device_ms": row.device_time_total / 1e3,
        "max_iterations": int(res.iterations.max()),
        "k1_launches": cs.read_launches()["btsolve"],
    }), flush=True)
    table = ka.table(sort_by="self_cuda_time_total", row_limit=30)
    with open(os.path.join(out, f"profile_replan_b{cs.B_FLEET}.txt"), "w") as fh:
        fh.write(card + "\n" + table)
    print("\n".join(table.splitlines()[:34]), flush=True)
    return 0


def profile_longhorizon(out, card, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gpmp2_tpu_torch.ops.btsolve import batched_block_tridiag_solve
    from gpmp2_tpu_torch.solver.partitioned import block_tridiag_solve_partitioned

    reps, solves = 5, []
    rng = np.random.default_rng(0)
    for n in cs.LH_NS:
        D, U, b = cs.lh_system(rng, n, dev)
        P = max(2, min(64, n // 64))
        solves.append((n, "K1", lambda D=D, U=U, b=b: batched_block_tridiag_solve(D, U, b)))
        solves.append((n, f"partitioned(P={P})", lambda D=D, U=U, b=b, P=P:
                       block_tridiag_solve_partitioned(D, U, b, P)))
    for *_, solve in solves:
        solve()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def records(prof):
        return [(e.time_range.start, e.name, e.time_range.elapsed_us())
                for e in prof.events() if e.device_type.name == "CUDA"]

    # one window: a marker kernel before each solver's solves and after the last
    with profile(activities=acts) as prof:
        for *_, solve in solves:
            torch.cuda._sleep(1000)
            for _ in range(reps):
                solve()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    pool = records(prof)
    for _ in range(5):
        if sum("spin_kernel" in e[1] for e in pool) > len(solves):
            break
        with profile(activities=acts) as late:
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
        pool += records(late)
    ev = sorted(pool)
    marks = [i for i, e in enumerate(ev) if "spin_kernel" in e[1]]
    if len(marks) != len(solves) + 1:
        raise RuntimeError(f"the profiler recorded {len(marks)} of {len(solves) + 1} markers")
    lines = [card]
    for (n, name, _), a, z in zip(solves, marks, marks[1:]):
        recs = [(kernel, us) for _, kernel, us in ev[a + 1:z]]
        k1 = [us for kernel, us in recs if "bt_kernel" in kernel]
        if len(k1) != reps:
            raise RuntimeError(f"{name} n={n}: {len(k1)} K1 records in {reps} solves")
        by_name = {}
        for kernel, us in recs:
            by_name[kernel] = by_name.get(kernel, 0.0) + us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        lines.append(json.dumps({
            "config": "longhorizon", "n": n, "B": cs.LH_B, "m": cs.LH_M, "solver": name,
            "busy_ms": sum(us for _, us in recs) / reps / 1e3, "k1_ms": sum(k1) / reps / 1e3,
            "kernels_per_solve": len(recs) / reps,
            "top": [[k[:60], us / reps / 1e3] for k, us in top], "card": card}))
        print(lines[-1], flush=True)
    with open(os.path.join(out, "profile_longhorizon.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

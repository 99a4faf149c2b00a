#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the device, and nvidia-smi's name and power limit;
2. build the CUDA kernels from gpmp2_tpu_torch/csrc (timed);
3. kernel K1 (block-tridiagonal solve) against its plain PyTorch version,
   which runs in float64 on the float32-rounded inputs;
4. kernel K2 (arm FK + sphere Jacobians) against its plain version;
5. the main path of bench.py through the port's entry points: the WAM
   7-DOF arm, the 300^3 WAMDeskDataset SDF on the device, B = 2048
   rejection-sampled collision-free endpoints (numpy seed 0), LM with
   max_iter 50 and rel_thresh 1e-2 in float32, best of 3 after a warm-up;
   both kernels' launch counts must grow during the solve;
6. agreement with a reference on a small input: four of those problems in
   float64 on the card (kernels) and on the CPU (plain versions).

It prints one informational JSON line of main-path metrics, the kernels'
JSON line, and last `{"ok": true, "device": {...}}`. Without a CUDA
device, or without the repository beside it, it exits non-zero before
printing any result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

B_MAIN = 2048
REPEATS = 3
BASE_START = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
BASE_GOAL = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn over `reps` launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def random_system(B, n, m, seed, damped=True):
    """Random SPD block-tridiagonal systems (float64 numpy)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, m, m))
    D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m)
    U = 0.3 * rng.normal(size=(B, n - 1, m, m))
    b = rng.normal(size=(B, n, m))
    lam = rng.uniform(0.0, 50.0, size=(B,)) if damped else np.zeros(B)
    return D, U, b, lam


def check_btsolve(dev):
    import torch
    from gpmp2_tpu_torch.ops.btsolve import (block_tridiag_solve_cuda,
                                             block_tridiag_solve_torch)

    cases = [  # (name, dtype, B, n, m, damped, scaling, relative tolerance)
        ("main", torch.float32, B_MAIN, 11, 14, True, True, 1e-4),
        ("ragged", torch.float32, 37, 5, 6, True, True, 1e-4),
        ("lambda0", torch.float32, B_MAIN, 11, 14, False, True, 1e-4),
        ("noscale", torch.float32, 100, 7, 4, True, False, 1e-4),
        ("f64", torch.float64, 64, 11, 14, True, True, 1e-10),
    ]
    main_err = None
    for name, dtype, B, n, m, damped, scaling, tol in cases:
        D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in random_system(B, n, m, seed=B + n + m, damped=damped))
        x = block_tridiag_solve_cuda(D, U, b, scaling, lam)
        torch.cuda.synchronize()
        x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(),
                                          scaling, lam.double())
        err = float((x.double() - x_ref).abs().max())
        scale = float(x_ref.abs().max())
        log(f"K1 {name}: B={B} n={n} m={m} {dtype} scaling={scaling} "
            f"max|dx|={err:.3e} max|x|={scale:.3e}")
        if not err <= tol * scale:
            raise AssertionError(f"K1 {name}: max|dx| {err} > {tol} * {scale}")
        if name == "main":
            main_err = err
    D, U, b, lam = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                    for a in random_system(B_MAIN, 11, 14, seed=1))
    ms = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 50)
    plain_ms = cuda_ms(lambda: block_tridiag_solve_torch(D, U, b, True, lam), 10)
    log(f"K1 time at B={B_MAIN} n=11 m=14 f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms}


def check_fk_arm(dev):
    import torch
    from gpmp2_tpu_torch.ops.fk_arm import (arm_fk_spheres_cuda,
                                            fk_spheres_torch, structure_arrays)
    from gpmp2_tpu_torch.robots import generate_arm

    model = generate_arm("WAMArm", dtype=torch.float64, device=dev)
    ref_ops = structure_arrays(model, torch.float64, dev)
    n_main = B_MAIN * 101
    main_err = None
    for N in (n_main, 1000):
        q64 = torch.as_tensor(np.random.default_rng(N).uniform(-2, 2, (N, 7)),
                              dtype=torch.float64, device=dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            q = q64.to(dtype)
            c, J = arm_fk_spheres_cuda(*structure_arrays(model, dtype, dev), q)
            torch.cuda.synchronize()
            c_ref, J_ref = fk_spheres_torch(*ref_ops, q.double())
            err = max(float((c.double() - c_ref).abs().max()),
                      float((J.double() - J_ref).abs().max()))
            log(f"K2: N={N} {dtype} max|d|={err:.3e}")
            if not err <= tol:
                raise AssertionError(f"K2 N={N} {dtype}: max|d| {err} > {tol}")
            if N == n_main and dtype == torch.float32:
                main_err = err
    ops = structure_arrays(model, torch.float32, dev)
    q = torch.as_tensor(np.random.default_rng(2).uniform(-2, 2, (n_main, 7)),
                        dtype=torch.float32, device=dev)
    ms = cuda_ms(lambda: arm_fk_spheres_cuda(*ops, q), 20)
    plain_ms = cuda_ms(lambda: fk_spheres_torch(*ops, q), 10)
    log(f"K2 time at N={n_main} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms}


def main_path_inputs(dev):
    """The main path's robot, SDF, setting, optimizer parameters, and B_MAIN
    start and goal configurations (float32 on `dev`)."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy
    from gpmp2_tpu_torch.obstacle.factors import obstacle_factor_error
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting
    from gpmp2_tpu_torch.robots import generate_arm

    f32 = torch.float32
    robot = generate_arm("WAMArm", dtype=f32, device=dev)
    ds = generate_3d_dataset("WAMDeskDataset")
    t0 = time.perf_counter()
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=f32, device=dev)
    log(f"SDF {tuple(sdf.data.shape)} {sdf.data.dtype} on {sdf.data.device}, "
        f"{sdf.data.numel() * sdf.data.element_size() / 1e6:.1f} MB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=9, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(7))
    params = optimizer_params_from_setting(setting)

    # bench.py's endpoints: perturbations of WAMPlannerExample.m's start and
    # goal, rejection-sampled so that every pinned endpoint is collision-free
    rng = np.random.default_rng(0)

    def sample_feasible(base, n):
        out = []
        while len(out) < n:
            cand = base + 0.05 * rng.normal(size=(2 * n, 7))
            q = torch.as_tensor(cand, dtype=f32, device=dev)
            free = (obstacle_factor_error(robot, sdf, q, 0.0).sum(-1) < 1e-6).cpu().numpy()
            out.extend(cand[free][: n - len(out)])
        return np.stack(out)

    starts = torch.as_tensor(sample_feasible(BASE_START, B_MAIN), dtype=f32, device=dev)
    goals = torch.as_tensor(sample_feasible(BASE_GOAL, B_MAIN), dtype=f32, device=dev)
    return robot, sdf, setting, params, starts, goals


def main_path(dev, card):
    import torch
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda
    from gpmp2_tpu_torch.planner import (collision_cost, init_traj_straight_line,
                                         make_problem, plan_batch)

    robot, sdf, setting, params, starts, goals = main_path_inputs(dev)
    zeros = torch.zeros_like(starts)

    def solve(b):
        probs = make_problem(robot, sdf, starts[:b], zeros[:b], goals[:b], zeros[:b], setting)
        init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                       setting.total_step, setting.total_time)
        res = plan_batch(probs, init, params)
        cc = collision_cost(probs, res.traj.pose)
        torch.cuda.synchronize()
        return res, cc

    solve(B_MAIN)  # warm-up
    times = []
    for _ in range(REPEATS):
        block_tridiag_solve_cuda.launches = 0
        arm_fk_spheres_cuda.launches = 0
        t0 = time.perf_counter()
        res, cc = solve(B_MAIN)
        times.append(time.perf_counter() - t0)
        launches = {"btsolve": block_tridiag_solve_cuda.launches,
                    "fk_arm": arm_fk_spheres_cuda.launches}
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel was not launched by the main path: {launches}")
    t_solve = min(times)

    for name, t in (("pose", res.traj.pose), ("vel", res.traj.vel),
                    ("error", res.error), ("collision cost", cc)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name} in the main-path result")
    if res.traj.pose.shape != (B_MAIN, 11, 7):
        raise AssertionError(f"trajectory shape {tuple(res.traj.pose.shape)}")
    conv = (res.converged & ~res.gave_up).cpu().numpy()
    gave = res.gave_up.cpu().numpy()
    free = (cc < 1e-4).cpu().numpy()
    converged_frac = float(conv.mean())
    collision_free_frac = float(free[conv].mean()) if conv.any() else 0.0
    if converged_frac < 0.95:
        raise AssertionError(f"converged_frac {converged_frac} < 0.95")
    if collision_free_frac < 0.99:
        raise AssertionError(f"collision-free among converged {collision_free_frac} < 0.99")

    def warm_latency_ms(b):
        solve(b)
        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            solve(b)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    metrics = {
        "metric": "wam7_lm_main_path", "batch": B_MAIN,
        "converged_frac": converged_frac,
        "gave_up_frac": float(gave.mean()),
        "collision_free_frac": collision_free_frac,
        "mean_iters": float(res.iterations.float().mean()),
        "solve_time_s": t_solve,
        "plans_per_s": float((conv & free).sum()) / t_solve,
        "latency_b1_ms": warm_latency_ms(1),
        "latency_b32_ms": warm_latency_ms(32),
        "card": card,
    }
    log(json.dumps(metrics))
    return launches, sdf, starts, goals, setting, params


def reference_agreement(dev, sdf, starts, goals, setting, params):
    """Four main-path problems in float64: the card (kernels) against the
    CPU (plain versions), on identical inputs."""
    import torch
    from gpmp2_tpu_torch.planner import (init_traj_straight_line, make_problem,
                                         plan_batch, traj_linearize)
    from gpmp2_tpu_torch.robots import generate_arm

    f64 = torch.float64
    out = []
    for where in (dev, torch.device("cpu")):
        s = starts[:4].to(device=where, dtype=f64)
        g = goals[:4].to(device=where, dtype=f64)
        z = torch.zeros_like(s)
        probs = make_problem(generate_arm("WAMArm", dtype=f64, device=where),
                             sdf.to(dtype=f64, device=where), s, z, g, z, setting)
        init = init_traj_straight_line(probs.space, s, g, setting.total_step,
                                       setting.total_time)
        lin = [t.cpu() for t in traj_linearize(probs, init)]
        res = plan_batch(probs, init, params)
        out.append((lin, res.error.cpu(), res.converged.cpu()))
    (lin_c, err_c, conv_c), (lin_p, err_p, conv_p) = out
    for name, a, b in zip(("H_diag", "H_off", "b", "err"), lin_c, lin_p):
        d = float((a - b).abs().max())
        if not d <= 1e-9 * float(b.abs().max()):
            raise AssertionError(f"linearize {name}: card vs CPU max|d| {d}")
    rel = float(((err_c - err_p).abs() / err_p.abs()).max())
    log(f"reference (f64, B=4): linearize agrees; final error rel diff {rel:.3e}, "
        f"converged card {conv_c.tolist()} cpu {conv_p.tolist()}")
    if not (rel <= 1e-6 and bool((conv_c == conv_p).all())):
        raise AssertionError("card and CPU plans disagree")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gpmp2_tpu_torch import _build  # fails here without the repository

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    # 2. build
    t0 = time.perf_counter()
    _build.kernels_lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    # 3, 4. kernels against their plain versions
    k1 = check_btsolve(dev)
    k2 = check_fk_arm(dev)

    # 5. main path
    launches, sdf, starts, goals, setting, params = main_path(dev, card)

    # 6. reference agreement on a small input
    reference_agreement(dev, sdf, starts, goals, setting, params)

    kernels = [
        {"name": "btsolve", "route": "cuda", "source": "gpmp2_tpu_torch/csrc/btsolve.cu",
         "replaces": "gpmp2_tpu/ops/btsolve.py:82", "launches": launches["btsolve"], **k1},
        {"name": "fk_arm", "route": "cuda", "source": "gpmp2_tpu_torch/csrc/fk_arm.cu",
         "replaces": "gpmp2_tpu/ops/fk_arm.py:62", "launches": launches["fk_arm"], **k2},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

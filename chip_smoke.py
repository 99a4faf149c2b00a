#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the device, and nvidia-smi's name and power limit;
2. build the CUDA kernels from gpmp2_tpu_torch/csrc (timed);
3. kernel K1 (block-tridiagonal solve) against its plain PyTorch version,
   which runs in float64 on the float32-rounded inputs, at the main,
   MobileBaseSE2 and SimpleTwoLinksArm shapes and the warp-per-problem
   edges (m = 2 and 34, n = 1, 2 and 101, B = 1, lambda = 0, scaling off,
   one lane with an indefinite block); timed at
   B = 2048 and B = 1; torch.linalg.solve on the same damped systems
   assembled dense is timed beside it;
4. kernel K2 (arm FK + sphere Jacobians) against its plain version, on
   WAM and Arm3 and on synthetic DH chains at the tile edges (N = 1, P - 1,
   P + 1 for d = 1, 3, 16 and S = 1, 13, 16);
5. kernel K3 (SDF lookup) against its plain version: the WAM main-path
   queries on the 300^3 field (packed and raw, float32 and float64), the
   OneObstacle 300^2 planar field, 8192 per-problem 64^2 worlds, and
   points on the top faces, outside the grid and NaN; timed at the main
   path's queries as the median of 5 timings, with nvidia-smi's SM and
   memory clocks before and after; then the assembly kernel against its
   plain version at the main path's shapes (B = 2048, its straight lines
   perturbed, every block within 1e-5 of its norm), timed on the straight
   lines with the L2 flushed and warm beside its bound;
6. the main path of bench.py through the port's entry points: the WAM
   7-DOF arm, the 300^3 WAMDeskDataset SDF packed on the device, B = 2048
   rejection-sampled collision-free endpoints (numpy seed 0), LM with
   max_iter 50 and rel_thresh 1e-2 in float32, best of 3 after a warm-up;
   K1, K2, K3 and the assembly kernel must each launch during the solve,
   the assembly kernel once a linearize (as often as K2);
7. agreement with a reference on a small input, in float64 on the card
   (kernels, raw field) and on the CPU (plain versions): four of those
   problems under LM, the same four under Dogleg, and four MobileBaseSE2
   problems (MobileMap1, vehicle dynamics) under LM;
8. the bench_suite.py paths through the port's entry points, at that
   script's batch sizes and draws (numpy seeds 0 and 1, drawn in its
   order): PointRobot2D (B = 16384), MobileBaseSE2 (B = 4096; SE(2)
   states, the Lie GP prior, vehicle dynamics sigma 0.001), Arm3Limits2D
   (B = 8192), WAM7_3D (B = 2048) and MultiWorld2D (B = 8192), LM in
   float32, best of 3 after a warm-up, plus the oracle's 512-problem sets
   solved with the float64 rescue on. Each config's q512 converged
   fraction must reach the oracle's, and its q512 collision-free fraction
   must lie within 0.02 of the oracle's (BASELINE_MEASURED_SUITE.json); K1
   and K3 must launch in every config, K2 in the arm configs;
9. Dogleg (the reference's default optimizer) on the main path's B = 2048
   WAM set in float32, best of 3 after a warm-up: K1, K2 and K3 must
   launch and every lane's final trajectory must be finite; its quality
   fractions are printed, not gated;
10. the mobile manipulators: K1 at the PR2's block size m = 36 (B = 2048,
   n = 11) in float32 and float64, damped and lambda = 0, against its
   plain version, timed with its bound; K3 against its plain version at
   the queries of the PR2 and SimpleTwoLinksArm rows (packed float32 and
   raw float64); the PR2 (SE(2) x R^15 states, 18 dof, 65 spheres, a
   torso lift and two 7-DOF arms) on the main path's 300^3 field, packed,
   with 324 self-collision pairs and vehicle dynamics, B = 2048 rejection-sampled endpoints (numpy seed 0), LM in
   float32, best of 3 after a warm-up (K1 and K3 must launch and every
   final trajectory must be finite; quality is printed, not gated: no
   oracle exists for the PR2); SimpleTwoLinksArm on the world and graph of
   tests/fixtures/oracle_replan_mobilearm.npz, whose float64 cold solve on
   the card must end within 1% of the oracle's cost, and a B = 4096
   float32 throughput line on that world; and four PR2 problems (a
   workspace pose slot, the self-collision pairs), and the same four with
   the end-effector goal, in float64 on the card against the CPU. The
   mobile FK is plain torch, so K2 launches 0 times in this phase;
11. incremental replanning: both replanning fixtures
   (tests/fixtures/oracle_replan_{pointrobot2d,mobilearm}.npz) replayed
   through ISAM2TrajOptimizer in float64 on the card, every final cost
   within 1% of the oracle's and every pinned pose within 1e-3; four
   point-robot sessions (ISAM2BatchSessions) in float64 on the card and
   on the CPU through a cold update and two rounds of pins, a partial-lane
   goal change and a state estimate, final errors within rel 1e-6 and
   iteration counts equal; and bench_replan.py's fleet of B = 1024 WAM
   sessions in float32 on the main path's field, packed (an untimed cold
   update and warm-up round, then 8 timed rounds of pins, state estimates
   and goal moves, warm updates of 3 steps): K1, K2 and K3 against their
   plain versions at the fleet's shapes (K1 on its own pinned normal
   equations), timed beside their bounds there, K1, K2 and K3 must each
   launch during the timed rounds and
   every final trajectory must be finite; throughput and quality are
   printed, not gated;
12. the manual graphs: K2 and K3 against their plain versions at the
   groups' shapes of wam_factor_graph.py's FactorGraph (10 and 90
   configurations, 160 and 1,440 queries; packed float32 and raw
   float64), timed with their bounds, K1 timed at B = 1 on the graph's
   normal equations; that graph built as the planner's recipe in float64
   on the card against traj_linearize's torch code (err within rtol
   1e-12, H and b within atol 1e-9), the assembly kernel's linearize
   against that code (each output within 1e-12 of its largest entry),
   and its optimize against plan_batch (rel 1e-9, equal iterations); the
   example's graph in float64, card against CPU (rel 1e-6, equal
   iterations); the example's graph in float32 on the packed
   field (it must converge with a finite trajectory, and K1, K2 and K3
   must each launch in the timed optimize), timed beside plan_batch at
   B = 1; mobile_arm2_factor_graph.py's graph beside an in-range disc in
   float64 under Gauss-Newton, card against CPU (rel 1e-6, equal
   iterations; K1 and K3 must launch); and multi_graph_point_robot.py's
   planner graph in float64, card against CPU (errors before and after
   within rel 1e-6, equal accepted steps, the same Dijkstra path; K3 must
   launch);
13. SE(3) states and the remaining examples: K1 at the Pose3 chain's
   block size m = 12 against its plain version, on the chain's own normal
   equations (B = 1, float64) and on random systems at B = 2048, n = 6 in
   float32 and float64, timed with its bound; the Pose3 chain (a
   FactorGraph on SE3Space: 6 states, dt 0.4, Qc = I6, endpoint priors at
   sigma 1e-2, LM) in float64, card against CPU (rel 1e-9, equal
   iterations; K1 must launch); and the thirteen examples_torch/ scripts
   of this phase (arm3_factor_graph, arm3_joint_limit, arm3_planner,
   mobile_2arms_factor_graph, mobile_arm_planning, mobile_base,
   point_robot_2d, point_robot_3d, point_robot_3d_rh, receding_horizon,
   wam_replanner, mobile_arm_replanner, wam_workspace_constraints) run in
   this process on the card and with --cpu: each runs to its end with its
   own asserts, K1 and K3 launch in every one and K2 in the five arm
   scripts, the card's final error is finite and within rel 1e-3 of the
   CPU's, the card converges where the CPU does, and the two loops reach
   their goal (or settle) on the card exactly when on the CPU;
14. long horizons and the mesh: bench_longhorizon.py's protocol (its
   random SPD systems from numpy seed 0, B = 256, m = 14, float32, at
   n = 65, 129, 257 and 1025): K1 and the partitioned solve (P = max(2,
   min(64, n // 64)); its separator system is K1), best of 3 after a
   warm-up on the host clock, the device time between two events around
   a solve, the worst lane's relative residual (below 1e-4), K1
   launching in both; both in float64 at n = 257 within rel 1e-10; no
   LONGHORIZON.json is written. Then a one-rank NCCL group (make_mesh):
   the ts-sharded solve of tests/test_partitioned.py's system (n = 127,
   m = 6, P = 8, float64) against K1 (rel 1e-10), and
   tests/test_sharding.py's 257-state point-robot planner (B = 8,
   float64, LM) with ts_mesh on a (dp = 1, ts = 1) mesh and ts_parts 8
   against plan_batch without one (rel 1e-8, equal iterations; K1 must
   launch). Then examples_torch/batch_fleet.py at its B = 256: its
   plan_fleet in this process on the mesh's dp dim, whose fleet_stats
   must equal the host sums of plan_batch's result on the same problems
   (n, converged and gave_up exactly, the mean error rel 1e-6; K1, K2 and
   K3 must launch), and the script itself, one spawned NCCL rank per
   card, which must end on its result line. The process group is
   destroyed at the end;
15. the opt-in SDF variants, K3's new instantiations: float16 and
   bfloat16 packed rows and the hull screen (WAMDeskDataset's boxes) and
   coarse screen (factor 8), both with each sphere's eps_total as the
   threshold, against their plain versions at the main path's queries
   (check_lookup; the float64 comparison leaves out the queries that the
   float32 and float64 bounds screen differently), the screens' recorded
   times before their persistent design on a line of their own, the
   corner-major planar table at PointRobot2D's queries on OneObstacle
   (its interleaved route), at MultiWorld2D's per-problem worlds (its
   direct route) and on the edges; each timed (device_ms, L2 flushed)
   beside its own bound (16-B rows for the narrow ones, no row bytes for
   a screened query, the boxes or the coarse table read once, a planar
   row counted once a world), with its screened fraction, the row-major
   planar default held to its plain version and timed beside it at both
   planar shapes, with
   F.grid_sample's bilinear distance (device_ms, L2 flushed) as the
   yardstick of both, and the default
   instantiation timed again, which must lie within 3% of its phase-5
   time; then the main path (phase 6's inputs) once with
   GPMP2_TPU_PACK_DTYPE=float16, once with the hull screen and once with
   the coarse screen, each gated at 0.95 converged and 0.99
   collision-free with K1-K3 launching, the screened runs equal to the
   unscreened run lane for lane (final errors within rel 1e-6, the same
   converged flags; the count of bit-unequal lanes printed); and
   PointRobot2D and Arm3Limits2D at the suite's throughput batches with
   the corner-major table, equal to the row-major runs in every lane;
16. the measuring entry points: bench_torch.py --config all spawned as its
   own script (the twins of bench.py, bench_suite.py, bench_replan.py and
   bench_longhorizon.py, built from this file's helpers): its rows by mode
   (1 main, 5 suite, 1 replan, 8 long-horizon), each with the card's line
   and the launches of its path's kernels in its last timed repeat, the
   main row's converged fraction and mean iterations equal to phase 6's
   and the suite rows' q512 fractions equal to phase 8's, vs_baseline set
   exactly when BASELINE_MEASURED_H100_HOST.json exists; then
   tools/oracle/suite_dump_torch.py into a temporary directory, each of
   its five files of the size its header gives.

Kernel times (K1, K2 and K3 at the main path's shapes, and at the
fleet's and the WAM graph's) are device times (device_ms: median,
min and max over 20 launches, each between two CUDA events behind a spin
kernel that keeps the card busy while the host enqueues them; K3 with
the L2 flushed before each launch, as the main path finds it after K2,
and also warm); the CUDA-event mean over back-to-back calls beside them
is labelled the call rate: at small shapes it is the host's launch rate,
not the kernel's. A phase-14 solve of many kernels gets the same pair
around it, which spans the card's idle gaps where the host is slower
(tools/profile_torch_main.py --config longhorizon sums its kernels).

It prints one informational JSON line of main-path metrics, one per suite
config, one for the Dogleg phase, one per mobile-manipulator row, one for
the WAM replanning fleet (session-updates/s and the launches of its timed
rounds), one for the WAM factor graph (`wam7_factor_graph`: the float32
optimize's time, attempts and launches beside plan_batch's at B = 1), one
per example of phase 13 (its card and CPU wall times, iterations, final
errors and launches), one per long-horizon (n, solver) and one for the
one-card ts planner and two for batch_fleet (phase 14), one per phase-15
main-path option and corner-major suite row, bench_torch.py's rows
(phase 16, each as that script printed it), a line of K1's and K2's
recorded times before their current designs (not measured in the run),
the kernels' JSON line (`ms` the device time and `call_rate_ms` beside
it; K1's entry with its m = 36 and m = 12 times and the Pose3 chain's
launches, every entry with its phase-14 launches, K3's with its
`variants`: each one's `ms`, `bound_ms`, `screened_fraction` and
main-path launches, and `ms_phase15`, the default's time again), and
last `{"ok": true, "device": {...}}`.
Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

B_MAIN = 2048
REPEATS = 3
BASE_START = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
BASE_GOAL = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
# published peaks of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# bench_suite.py's batch sizes: the oracle's problem sets and the
# throughput batches (SUITE_B_* defaults there)
SUITE_BATCH = {"q512": 512, "PointRobot2D": 16384, "MobileBaseSE2": 4096,
               "Arm3Limits2D": 8192, "WAM7_3D": 2048, "MultiWorld2D": 8192}
# K1's and K2's times at the same shapes before their current designs
# (one thread per problem, one thread per configuration), as PERF.md's
# kernel table records them (NVIDIA H100 80GB HBM3, 700.00 W); printed
# for reference on a line of their own, never in the kernels' JSON line
RECORDED_PREV_MS = {"btsolve": 0.691, "fk_arm": 2.205}
# K3's hull and coarse screens at the main path's queries as one thread a
# query, before their persistent design (PERF.md's kernel table: device
# times, L2 flushed, two runs); printed on a line of their own in phase 15
RECORDED_SCREEN_MS = {"hull": (0.0945, 0.0955), "coarse": (0.0631, 0.0633)}
# K3's time at the main path's queries is the median of this many timings
K3_REPEATS = 5


def log(*args):
    print(*args, flush=True)


def sync():
    """Wait for the card's queued work; a run that never touched CUDA (the
    plain versions on the CPU) has none."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def nvidia_smi_card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()


def gpu_clocks():
    """The card's SM and memory clocks as nvidia-smi reports them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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


# bytes written before each timed launch where the caller finds the 50 MB L2
# cold: the main path's K3 runs after K2 wrote 278 MB of Jacobians
FLUSH_BYTES = 256 << 20
# cycles of torch.cuda._sleep's spin before each timed call (~0.2 ms at the
# H100's 1980 MHz): longer than the host takes to enqueue a kernel's launch
SPIN_CYCLES = 400_000


def device_ms(fn, reps=20, flush=False):
    """The device time of a call of fn, not the host's call rate: (median,
    min, max) ms over `reps` calls, each between two CUDA events. A spin
    kernel keeps the card busy while the host enqueues the events and the
    launches, so for a call of one kernel the host's time falls outside
    the pair; for a call of many kernels that the host enqueues more
    slowly than the card runs them, the pair spans the card's idle gaps
    too. With `flush`, a FLUSH_BYTES write before each call evicts the
    L2; with flush="read", a FLUSH_BYTES read (a sum), which evicts it
    and leaves no dirty line for the call to write back."""
    import torch

    buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush == "read":
            buf.sum()
        elif buf is not None:
            buf.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in pairs)
    return ms[len(ms) // 2], ms[0], ms[-1]


def bound(nbytes, flops, flops_per_s=F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(B, n, m, itemsize=4, flops_per_s=F32_FLOPS):
    """K1's bound for B damped systems of n blocks of m: D, U, b and lambda
    read once and x written once; the operations of the block recurrence
    (per block: Cholesky m^3/3, the [U | z] solve and the U^T X carry
    4 m^2 (m + 1), back substitution 2 m^2)."""
    nbytes = itemsize * B * (n * m * m + (n - 1) * m * m + 2 * n * m + 1)
    return bound(nbytes, B * n * (m**3 / 3 + 4 * m * m * (m + 1) + 2 * m * m), flops_per_s)


def k2_bound(N, d, S):
    """K2's bound for N float32 configurations of d joints and S spheres:
    the configurations read once, the centres and Jacobians written once;
    the chain's and the spheres' operations."""
    return bound(4 * N * (d + S * 3 + S * 3 * d), N * (40 * d + S * (12 + 9 * d)))


def k3_bound(pts, sdf, read=None, row_bytes=None, once_bytes=0, screen_flops=0, qpw=0):
    """K3's bound for float32 queries pts (N, dim) on a packed field, query
    i in world i // qpw (qpw 0: one shared world): the points read once,
    the distinct packed rows (world and cell) of the queries that `read`
    (default all) touch read once, `row_bytes` each
    (default 4 bytes a corner), the screen's operands (`once_bytes`) read
    once, the dim + 1 outputs and the mask written once; the
    interpolation's operations on the rows read (120 in 3D, 40 in 2D)
    and `screen_flops` a query. Returns (bound_ms, bound_by, distinct
    rows)."""
    import torch

    dim = sdf.DIM
    c = _cell_coords(pts.double(), sdf).clamp(min=0)
    grid = sdf.grid
    lo = [c[:, k].floor().clamp(max=s - 2).long() for k, s in enumerate(grid[::-1])]
    base = lo[1] * grid[-1] + lo[0] + (lo[2] * grid[-1] * grid[-2] if dim == 3 else 0)
    if qpw:
        base = base + torch.arange(pts.shape[0], device=pts.device) // qpw * sdf.cells
    n_read = pts.shape[0] if read is None else int(read.sum())
    touched = int(torch.unique(base if read is None else base[read]).numel())
    N = pts.shape[0]
    row_bytes = 4 * 2 ** dim if row_bytes is None else row_bytes
    return (*bound(N * dim * 4 + touched * row_bytes + once_bytes + N * ((dim + 1) * 4 + 1),
                   n_read * (120 if dim == 3 else 40) + N * screen_flops), touched)


def check_btsolve(dev):
    import torch
    from gpmp2_tpu_torch.ops.btsolve import (block_tridiag_solve_cuda,
                                             block_tridiag_solve_torch)
    from gpmp2_tpu_torch.testing import random_system

    f32, f64 = torch.float32, torch.float64
    cases = [  # (name, dtype, B, n, m, damped, scaling, relative tolerance)
        ("main", f32, B_MAIN, 11, 14, True, True, 1e-4),
        ("ragged", f32, 37, 5, 6, True, True, 1e-4),
        ("lambda0", f32, B_MAIN, 11, 14, False, True, 1e-4),
        ("noscale", f32, 100, 7, 4, True, False, 1e-4),
        ("f64", f64, 64, 11, 14, True, True, 1e-10),
        ("f64_m4", f64, 256, 11, 4, True, True, 1e-10),
        ("f64_m6", f64, 256, 11, 6, True, True, 1e-10),
        # MobileBaseSE2 (B = 4096, n = 16, m = 6) and Dogleg's GN point
        ("mobile", f32, 4096, 16, 6, True, True, 1e-4),
        ("mobile_lambda0", f32, 4096, 16, 6, False, True, 1e-4),
        # SimpleTwoLinksArm's row (B = 4096, n = 11, m = 10)
        ("two_links", f32, 4096, 11, 10, True, True, 1e-4),
        ("two_links_lambda0", f32, 4096, 11, 10, False, True, 1e-4),
    ]
    # the warp-per-problem edges, on systems conditioned alike at every m:
    # the smallest and largest block, one and two blocks, a long chain, a
    # single problem, and the largest block in float64 (29.6 KB per warp)
    edges = [
        ("m2", f32, 33, 11, 2, True, True, 1e-4),
        ("m34", f32, 33, 11, 34, True, True, 1e-4),
        ("n1", f32, 33, 1, 14, True, True, 1e-4),
        ("n2", f32, 33, 2, 14, True, True, 1e-4),
        ("n101", f32, B_MAIN, 101, 14, True, True, 1e-4),
        ("B1", f32, 1, 11, 14, True, True, 1e-4),
        ("f64_m34", f64, 33, 11, 34, True, True, 1e-10),
        ("f64_lambda0_noscale", f64, 33, 11, 14, False, False, 1e-10),
    ]
    main_err = None
    for cond, (name, dtype, B, n, m, damped, scaling, tol) in (
            [(False, c) for c in cases] + [(True, c) for c in edges]):
        D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in random_system(B, n, m, seed=B + n + m, damped=damped,
                                               conditioned=cond))
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
    check_btsolve_indefinite_lane(dev)
    B, n, m = B_MAIN, 11, 14
    D, U, b, lam = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                    for a in random_system(B, n, m, seed=1))
    call_ms = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 50)
    dev_ms = device_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam))
    D1, U1, b1, lam1 = (t[:1].contiguous() for t in (D, U, b, lam))
    call_ms_b1 = cuda_ms(lambda: block_tridiag_solve_cuda(D1, U1, b1, True, lam1), 50)
    dev_ms_b1 = device_ms(lambda: block_tridiag_solve_cuda(D1, U1, b1, True, lam1))
    # MobileBaseSE2's shape with lambda = 0, as Dogleg's Gauss-Newton point
    Dm, Um, bm, lm = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in random_system(4096, 16, 6, seed=2, damped=False))
    ms_m6 = cuda_ms(lambda: block_tridiag_solve_cuda(Dm, Um, bm, True, lm), 50)
    m6_bound, m6_by = k1_bound(4096, 16, 6)
    plain_ms = cuda_ms(lambda: block_tridiag_solve_torch(D, U, b, True, lam), 10)
    # the same damped systems, dense (B, n m, n m), for one library call
    H = torch.zeros((B, n, m, n, m), dtype=torch.float32, device=dev)
    idx = torch.arange(n, device=dev)
    H[:, idx, :, idx, :] = D.transpose(0, 1)
    H[:, idx[:-1], :, idx[1:], :] = U.transpose(0, 1)
    H[:, idx[1:], :, idx[:-1], :] = U.transpose(0, 1).mT
    H = H.reshape(B, n * m, n * m) + lam[:, None, None] * torch.eye(n * m, device=dev)
    rhs = b.reshape(B, n * m, 1)
    library_ms = cuda_ms(lambda: torch.linalg.solve(H, rhs), 10)
    x_lib = torch.linalg.solve(H, rhs).reshape(B, n, m)
    lib_err = float((x_lib - block_tridiag_solve_cuda(D, U, b, True, lam)).abs().max())
    bound_ms, bound_by = k1_bound(B, n, m)
    log(f"K1 time at B={B} n={n} m={m} f32: kernel device time {_spread(dev_ms)}, call rate "
        f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.solve dense {library_ms:.4f} ms (max|dx| vs K1 {lib_err:.2e}), "
        f"bound {bound_ms:.4f} ms ({bound_by}); kernel at B=1 device time {_spread(dev_ms_b1)}, "
        f"call rate {call_ms_b1:.4f} ms; at B=4096 n=16 m=6 lambda=0 call rate {ms_m6:.4f} ms "
        f"(bound {m6_bound:.4f} ms, {m6_by})")
    return {"max_abs_err": main_err, "ms": dev_ms[0], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "call_rate_ms": call_ms, "ms_b1": dev_ms_b1[0], "call_rate_ms_b1": call_ms_b1,
            "call_rate_ms_m6_b4096": ms_m6}


def _spread(t):
    """A (median, min, max) device time as text."""
    return f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})"


def check_btsolve_indefinite_lane(dev):
    """An indefinite block on one lane: that lane's x is non-finite in the
    kernel and the plain version alike, and every other lane agrees."""
    import torch
    from gpmp2_tpu_torch.ops.btsolve import (block_tridiag_solve_cuda,
                                             block_tridiag_solve_torch)
    from gpmp2_tpu_torch.testing import random_system

    B, n, m, bad = 33, 11, 14, 7
    D, U, b, lam = random_system(B, n, m, seed=9, conditioned=True)
    # off-diagonal 3 sqrt(d0 d1): a negative pivot after damping and scaling
    d0, d1 = D[bad, 5, 0, 0] + lam[bad], D[bad, 5, 1, 1] + lam[bad]
    D[bad, 5, 0, 1] = D[bad, 5, 1, 0] = 3 * np.sqrt(d0 * d1)
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        Dt, Ut, bt, lt = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (D, U, b, lam))
        x = block_tridiag_solve_cuda(Dt, Ut, bt, True, lt)
        x_ref = block_tridiag_solve_torch(Dt.double(), Ut.double(), bt.double(), True,
                                          lt.double())
        good = torch.arange(B, device=dev) != bad
        xg, rg = x[good].double(), x_ref[good]
        err = float((xg - rg).abs().max())
        log(f"K1 indefinite lane {dtype}: lane finite {bool(torch.isfinite(x[bad]).any())}, "
            f"others max|dx|={err:.3e}")
        if bool(torch.isfinite(x[bad]).any()) or bool(torch.isfinite(x_ref[bad]).any()):
            raise AssertionError(f"K1 indefinite lane {dtype}: finite values on the bad lane")
        if not (bool(torch.isfinite(xg).all()) and err <= tol * float(rg.abs().max())):
            raise AssertionError(f"K1 indefinite lane {dtype}: other lanes max|dx| {err}")


def assemble_bound(B, n, T, S, d, itemsize=4):
    """The assembly kernel's bound for B problems of n support states, T
    interpolated states an interval, S spheres and d dims: K2's Jacobians,
    K3's four values and mask, the states and the per-lane prior operands
    read once, H_diag, H_off, b and err written once; the operations of
    the general factored form (the J rows, each state's Gram upper
    triangle and gradient, each interval's G_t C_t and the widened block's
    upper 2 x 2 tiles, two a multiply-add)."""
    C, m = n + (n - 1) * T, 2 * d
    nbytes = (B * C * S * ((3 * d + 4) * itemsize + 1)
              + B * (2 * n + 6) * d * itemsize
              + B * (n * m * m + (n - 1) * m * m + n * m + 1) * itemsize)
    macs = B * (C * S * (3 * d + d * (d + 1) // 2 + d)
                + (n - 1) * T * (4 * d ** 3 + 2 * d * (2 * d + 1) * d))
    return bound(nbytes, 2 * macs)


def assemble_ratio(got, want):
    """The largest |difference| of the assembly's outputs over each block's
    norm: the (m, m) blocks of H_diag and H_off, the m-vectors of b, each
    lane's err."""
    worst = 0.0
    for a, w, k in zip(got, want, (2, 2, 1, 0)):
        diff, w = a.double() - w.double(), w.double()
        dn, wn = ((diff.flatten(-k).norm(dim=-1), w.flatten(-k).norm(dim=-1)) if k
                  else (diff.abs(), w.abs()))
        if bool((dn > 0).any()):
            worst = max(worst, float((dn / wn).max()))
    return worst


def check_assemble(dev, inputs):
    """The assembly kernel against its plain version (float64 on the same
    rounded operands; every block within 1e-5 of its norm) at the main
    path's shapes, on its straight lines perturbed by 0.1 N(0, 1) (on the
    straight line the GP residual cancels to rounding); then timed on the
    straight lines, as the first linearize finds them, with the L2 flushed
    (the linearize runs it after K3, which reads the 864 MB table) and
    warm, beside its bound and its plain version."""
    import torch
    from gpmp2_tpu_torch.ops.assemble import assemble_vec_cuda, assemble_vec_torch
    from gpmp2_tpu_torch.planner import Trajectory, init_traj_straight_line
    from gpmp2_tpu_torch.planner.batch import make_problem
    from gpmp2_tpu_torch.planner.problem import (_assembly_operands, _collision_confs,
                                                 _spheres_and_jac)

    robot, sdf, setting, _, starts, goals = inputs
    z = torch.zeros_like(starts)
    probs = make_problem(robot, sdf, starts, z, goals, z, setting, sdf_pack=False)
    line = init_traj_straight_line(probs.space, starts, goals, setting.total_step,
                                   setting.total_time)
    g = torch.Generator(device=dev).manual_seed(0)
    bent = Trajectory(*(t + 0.1 * torch.randn(t.shape, generator=g, device=dev) for t in line))

    def operands(traj):
        centers, Jc = _spheres_and_jac(probs.robot, _collision_confs(probs, *traj))
        return _assembly_operands(probs, *traj, centers, Jc)

    ops = operands(bent)
    got = assemble_vec_cuda(*ops)
    ref = assemble_vec_torch(*(t.double() if torch.is_tensor(t) and t.is_floating_point()
                               else t for t in ops))
    ratio = assemble_ratio(got, ref)
    log(f"assembly: main path, perturbed, f32 against the plain version in f64: worst "
        f"|d| / block norm {ratio:.3e}")
    if not ratio <= 1e-5:
        raise AssertionError(f"assembly kernel: |d| / block norm {ratio} > 1e-5")
    ops = operands(line)
    active = float((ops[7] & (ops[3] <= ops[8])).float().mean())
    dev_ms = device_ms(lambda: assemble_vec_cuda(*ops), flush=True)
    warm_ms = device_ms(lambda: assemble_vec_cuda(*ops))
    call_ms = cuda_ms(lambda: assemble_vec_cuda(*ops), 20)
    plain_ms = cuda_ms(lambda: assemble_vec_torch(*ops), 5)
    B, n, d = line.pose.shape
    S, T = ops[2].shape[2], ops[10].shape[0]
    bound_ms, bound_by = assemble_bound(B, n, T, S, d)
    log(f"assembly time at B={B} f32 (straight lines, {active:.1%} of spheres active): "
        f"kernel device time L2 flushed {_spread(dev_ms)}, warm {_spread(warm_ms)}, call "
        f"rate {call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {bound_ms / dev_ms[0]:.1%} of it flushed)")
    return {"max_block_ratio": ratio, "ms": dev_ms[0], "ms_warm": warm_ms[0],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "call_rate_ms": call_ms, "active_share": active}


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
    arm3 = generate_arm("SimpleThreeLinksArm", dtype=torch.float64, device=dev)
    q = torch.as_tensor(np.random.default_rng(3).uniform(-2, 2, (4096, 3)),
                        dtype=torch.float64, device=dev)
    c, J = arm_fk_spheres_cuda(*structure_arrays(arm3, torch.float64, dev), q)
    c_ref, J_ref = fk_spheres_torch(*structure_arrays(arm3, torch.float64, dev), q)
    err = max(float((c - c_ref).abs().max()), float((J - J_ref).abs().max()))
    log(f"K2: Arm3 d=3 N=4096 float64 max|d|={err:.3e}")
    if not err <= 1e-12:
        raise AssertionError(f"K2 Arm3 f64: max|d| {err} > 1e-12")
    check_fk_arm_tiles(dev, n_main)
    ops = structure_arrays(model, torch.float32, dev)
    q = torch.as_tensor(np.random.default_rng(2).uniform(-2, 2, (n_main, 7)),
                        dtype=torch.float32, device=dev)
    call_ms = cuda_ms(lambda: arm_fk_spheres_cuda(*ops, q), 20)
    dev_ms = device_ms(lambda: arm_fk_spheres_cuda(*ops, q))
    plain_ms = cuda_ms(lambda: fk_spheres_torch(*ops, q), 10)
    S, d = 16, 7
    bound_ms, bound_by = k2_bound(n_main, d, S)
    log(f"K2 time at N={n_main} f32: kernel device time {_spread(dev_ms)}, call rate "
        f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": main_err, "ms": dev_ms[0], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "call_rate_ms": call_ms}


def check_fk_arm_tiles(dev, n_main):
    """K2's tile edges on synthetic DH chains: one configuration, one short
    of a tile and one over, at d = 1, 3 and 16 and S = 1, 13 and 16, in
    float32 and float64, and a 16-joint chain at the main-path count; the
    plain version runs in float64 on the same rounded operands."""
    import torch
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda, fk_spheres_torch, launch_plan
    from gpmp2_tpu_torch.testing import dh_chain

    for d, S in ((16, 16), (1, 1), (3, 13)):
        arrays = dh_chain(d, S, seed=d * 100 + S)
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            ops = [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays[:3]]
            ops.append(torch.as_tensor(arrays[3], dtype=torch.int32, device=dev))
            ref_ops = [t.double() for t in ops[:3]] + ops[3:]
            P = launch_plan(d, S, dtype)[0]
            counts = [1, P - 1, P + 1] + ([n_main] if d == 16 and dtype == torch.float32
                                          else [])
            worst = 0.0
            for N in counts:
                q = torch.as_tensor(np.random.default_rng(N).uniform(-2, 2, (N, d)),
                                    dtype=dtype, device=dev)
                c, J = arm_fk_spheres_cuda(*ops, q)
                c_ref, J_ref = fk_spheres_torch(*ref_ops, q.double())
                err = max(float((c.double() - c_ref).abs().max()),
                          float((J.double() - J_ref).abs().max()))
                if not err <= tol:
                    raise AssertionError(f"K2 chain d={d} S={S} N={N} {dtype}: "
                                         f"max|d| {err} > {tol}")
                worst = max(worst, err)
            log(f"K2 chain d={d} S={S} {dtype} tile P={P}, N in {counts}: max|d|={worst:.3e}")


def _cell_coords(pts, sdf):
    """Cell coordinates (N, dim) of float64 points."""
    dim = sdf.DIM
    return (pts[:, :dim] - sdf.origin.double()) / sdf.cell_size.double()


def _compare_lookup(name, got, ref, near, tol):
    """Hold K3's outputs against the float64 plain version's: `ok` exactly
    and every output within tol * its max magnitude, except on `near`
    queries (a cell coordinate within 1e-4 cells of a cell boundary, where
    the float32 kernel may pick the neighbouring cell: the interpolant is
    continuous there, its gradient jumps), which hold dist only."""
    import torch

    keep = ~near
    if not torch.equal(got[-1][keep], ref[-1][keep]):
        raise AssertionError(f"K3 {name}: in-range masks differ")
    worst = 0.0
    for k, (g, r) in enumerate(zip(got[:-1], ref[:-1])):
        sel = torch.ones_like(keep) if k == 0 else keep
        g, r = g[sel].double(), r[sel]
        finite = torch.isfinite(r)
        if not torch.equal(torch.isfinite(g), finite):
            raise AssertionError(f"K3 {name}: output {k} non-finite where the plain is not")
        scale = float(r[finite].abs().max()) if finite.any() else 1.0
        err = float((g[finite] - r[finite]).abs().max()) if finite.any() else 0.0
        if not err <= tol * scale:
            raise AssertionError(f"K3 {name}: output {k} max|d| {err} > {tol} * {scale}")
        worst = max(worst, err)
    log(f"K3 {name}: N={got[0].shape[0]} max|d|={worst:.3e} "
        f"({int(near.sum())} queries near a cell boundary hold dist only)")
    if not bool(keep.any()):
        raise AssertionError(f"K3 {name}: no query away from a cell boundary")
    return worst


def _lookup_operands(sdf, packed):
    """K3's table, origin, cell size and grid of a field: its packed rows
    (a corner-major table as (W, 4, cells)) or its raw samples."""
    if not packed:
        t = sdf.data.reshape(-1)
    elif sdf.corner_major:
        t = sdf.packed.reshape(-1, 4, sdf.cells)
    else:
        t = sdf.packed.reshape(-1, 2 ** sdf.DIM)
    return t, sdf.origin, sdf.cell_size, sdf.grid


def _variant(sdf, packed, thresh=None):
    """K3's keywords for a field's table layout and, given the thresholds
    (S,), its screen (the hull screen where the field has boxes)."""
    kw = {"corner_major": True} if packed and sdf.corner_major else {}
    if thresh is not None:
        kw["thresh"] = thresh
        if sdf.screen_boxes is not None:
            kw["boxes"] = sdf.screen_boxes
        else:
            kw.update(coarse=sdf.coarse, coarse_cell=sdf.coarse_cell)
    return kw


def check_lookup(name, sdf, pts, packed, qpw=0, thresh=None):
    """K3 on `pts` (N, >= dim) against its plain version in float64 on the
    same rounded inputs (relative tolerance 1e-4 in float32: the cell
    coordinate carries a float32 rounding of ~2e-5 cells, which moves the
    gradient weights; 1e-12 in float64), and a float32 kernel also against
    the plain version in float32 on every query (1e-5: the same cells,
    other rounding). A narrow packed table stays narrow in the float64
    plain version. With `thresh` (S,) the field's screen is on; queries
    that the float32 and float64 bounds screen differently, or screen
    with bounds 1e-4 of the largest apart (a point whose float32 coarse
    coordinate rounds into the neighbouring coarse block, whose bound
    jumps), leave the float64 comparison; the float32 one holds every
    query (the kernel's bound has the plain version's rounding). Returns
    the largest difference."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.ops.sdf_lookup import screen_bound, sdf_lookup_cuda, sdf_lookup_torch

    tol = 1e-4 if pts.dtype == torch.float32 else 1e-12
    kw = _variant(sdf, packed, thresh)
    got = sdf_lookup_cuda(pts, *_lookup_operands(sdf, packed), qpw, **kw)
    torch.cuda.synchronize()
    s64 = (sdf if packed else dataclasses.replace(sdf, packed=None)).to(dtype=torch.float64)
    kw64 = _variant(s64, packed, None if thresh is None else thresh.double())
    ref = sdf_lookup_torch(pts.double(), *_lookup_operands(s64, packed), qpw, **kw64)
    if pts.dtype == torch.float32:
        c = _cell_coords(pts.double(), sdf)
        near = ((c - c.round()).abs() < 1e-4).any(-1)
        # and every query against the plain version in float32, which
        # picks the same cells: only FMA contraction differs
        same = sdf_lookup_torch(pts, *_lookup_operands(sdf, packed), qpw, **kw)
        _compare_lookup(name + " (plain f32)", got, same, torch.zeros_like(near), 1e-5)
    else:
        near = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    if thresh is not None:
        screen = {k: v for k, v in kw.items() if k != "corner_major"}
        screen64 = {k: v for k, v in kw64.items() if k != "corner_major"}
        b32, s32 = screen_bound(pts, sdf.origin, sdf.cell_size, **screen)
        b64, s64m = screen_bound(pts.double(), s64.origin, s64.cell_size, **screen64)
        held = s64m & b64.isfinite()
        scale = float(b64[held].abs().max()) if held.any() else 1.0
        apart = (b32.double() - b64).abs() > 1e-4 * scale
        same_screen = (s32 == s64m) & ~(s32 & apart)
        log(f"K3 {name}: {int((s32 != s64m).sum())} queries screened differently and "
            f"{int((s32 & s64m & apart).sum())} with bounds apart in float32 and float64 "
            f"leave the float64 comparison")
        got = [t[same_screen] for t in got]
        ref = [t[same_screen] for t in ref]
        near = near[same_screen]
    return _compare_lookup(name, got, ref, near, tol)


def check_sdf_lookup(dev, wam_sdf, wam_pts):
    """K3 against its plain version (check_lookup) at the main path's, the
    suite's and the edges' queries; timed at the main path's."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF, pack_planar_sdf, pack_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    f32, f64 = torch.float32, torch.float64
    wam_packed = pack_sdf(wam_sdf)
    main_err = check_lookup("WAM packed f32", wam_packed, wam_pts, True)
    check_lookup("WAM raw f32", wam_packed, wam_pts, False)
    wam64 = pack_sdf(wam_sdf.to(dtype=f64))
    check_lookup("WAM packed f64", wam64, wam_pts.double(), True)
    check_lookup("WAM raw f64", wam64, wam_pts.double(), False)
    del wam64

    rng = np.random.default_rng(7)
    ds = generate_2d_dataset("OneObstacleDataset")
    planar = pack_planar_sdf(planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map,
                                                       device=dev))
    ext = np.array([ds.cols, ds.rows]) * ds.cell_size
    n_pr = 16384 * 61  # PointRobot2D: B = 16384, 61 collision states, 1 sphere
    pts2 = torch.as_tensor(ds.origin + rng.uniform(-0.05, 1.05, (n_pr, 2)) * ext,
                           dtype=f32, device=dev)
    check_lookup("OneObstacle packed f32", planar, pts2, True)
    check_lookup("OneObstacle raw f64", planar.to(dtype=f64), pts2.double(), False)

    # MobileBaseSE2: B = 4096, 16 support + 45 interpolated states, 1 sphere,
    # on MobileMap1 (a constant field: its obstacles lie outside its grid)
    dsm = generate_2d_dataset("MobileMap1")
    mobile = pack_planar_sdf(planar_sdf_from_occupancy(dsm.origin, dsm.cell_size, dsm.map,
                                                       device=dev))
    ext_m = np.array([dsm.cols, dsm.rows]) * dsm.cell_size
    ptsm = torch.as_tensor(dsm.origin + rng.uniform(-0.1, 1.1, (4096 * 61, 2)) * ext_m,
                           dtype=f32, device=dev)
    check_lookup("MobileMap1 packed f32", mobile, ptsm, True)
    check_lookup("MobileMap1 raw f64", mobile.to(dtype=f64), ptsm.double(), False)

    # MultiWorld2D: 8192 worlds of 64^2, 33 collision states each
    n, Bw, qpw = 64, 8192, 33
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    cys = rng.uniform(-0.3, 0.3, Bw)
    data = np.sqrt(X[None] ** 2 + (Y[None] - cys[:, None, None]) ** 2) - 0.3
    worlds = pack_planar_sdf(PlanarSDF(
        torch.tensor([-1.5, -1.5], dtype=f32, device=dev),
        torch.tensor(3.0 / (n - 1), dtype=f32, device=dev),
        torch.as_tensor(data, dtype=f32, device=dev)))
    ptsw = torch.as_tensor(rng.uniform(-1.6, 1.6, (Bw * qpw, 2)), dtype=f32, device=dev)
    check_lookup("MultiWorld packed f32", worlds, ptsw, True, qpw)
    check_lookup("MultiWorld raw f64", worlds.to(dtype=f64), ptsw.double(), False, qpw)

    for name, field in (("WAM", wam_packed), ("OneObstacle", planar)):
        check_lookup_edges(name, field, dev, (True, False))

    table, origin, cell, grid = _lookup_operands(wam_packed, True)
    lookup = lambda: sdf_lookup_cuda(wam_pts, table, origin, cell, grid)  # noqa: E731
    # the call rate's median of K3_REPEATS timings, then the kernel's device
    # time over 20 launches with the L2 flushed before each (as the main
    # path finds it) and without, with the clocks around them
    clocks = [gpu_clocks()]
    runs = sorted(cuda_ms(lookup, 20) for _ in range(K3_REPEATS))
    cold = device_ms(lookup, flush=True)
    warm = device_ms(lookup)
    clocks.append(gpu_clocks())
    call_ms = runs[len(runs) // 2]
    plain_ms = cuda_ms(lambda: sdf_lookup_torch(wam_pts, table, origin, cell, grid), 5)
    bound_ms, bound_by, touched = k3_bound(wam_pts, wam_packed)
    N = wam_pts.shape[0]
    log(f"K3 call rate at N={N} f32 packed (WAM main path), {K3_REPEATS} repeats of 20 "
        f"launches: min {runs[0]:.4f}, median {call_ms:.4f}, max {runs[-1]:.4f} ms; "
        f"clocks.sm, clocks.mem before: {clocks[0]}, after: {clocks[1]}")
    log(f"K3 at N={N}: kernel device time, L2 flushed {_spread(cold)} "
        f"({100 * bound_ms / cold[0]:.1f}% of the bound), L2 warm {_spread(warm)} "
        f"({100 * bound_ms / warm[0]:.1f}%); plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {touched} distinct rows)")
    grid_sample_ms = _grid_sample_ms(wam_sdf, wam_pts)
    log(f"K3 yardstick: F.grid_sample (distance only, no gradient), call rate (CUDA events "
        f"over 20 back-to-back calls, not a device time) {grid_sample_ms:.4f} ms")
    return {"max_abs_err": main_err, "ms": cold[0], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_l2_warm": warm[0], "call_rate_ms": call_ms}


def check_lookup_edges(name, field, dev, packings):
    """K3 against its plain version on the edges: the low and top faces,
    one step outside each, and NaN, on the field moved to a dyadic grid
    (origin -1, cell 1/128), where the face points are exact in both
    dtypes; each packing of `packings` (True: the field's packed table,
    False: its raw samples) in float32 and float64."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    sdf = dataclasses.replace(field, origin=torch.full_like(field.origin, -1.0),
                              cell_size=torch.full_like(field.cell_size, 1 / 128))
    o = sdf.origin.double()
    top = o + (torch.tensor(sdf.grid[::-1], device=dev) - 1).double() * sdf.cell_size.double()
    mid = 0.5 * (o + top)
    pts = [o, top, mid]
    for k in range(sdf.DIM):
        for face, step in ((top, 1 / 1024), (o, -1 / 1024)):
            on = mid.clone()
            on[k] = face[k]
            out = on.clone()
            out[k] = out[k] + step
            pts += [on, out]
    nan = mid.clone()
    nan[0] = float("nan")
    pts = torch.stack(pts + [nan])
    for dtype in (torch.float32, torch.float64):
        s = sdf.to(dtype=dtype)
        p = pts.to(dtype)
        for packed in packings:
            kw = _variant(s, packed)
            got = sdf_lookup_cuda(p, *_lookup_operands(s, packed), **kw)
            ref = sdf_lookup_torch(p, *_lookup_operands(s, packed), **kw)
            want_ok = [True] * 3 + [True, False] * (2 * sdf.DIM) + [False]
            if got[-1].tolist() != want_ok or ref[-1].tolist() != want_ok:
                raise AssertionError(f"K3 {name} edges {dtype}: in-range mask "
                                     f"{got[-1].tolist()}")
            for g, r in zip(got[:-1], ref[:-1]):
                if not torch.allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True):
                    raise AssertionError(f"K3 {name} edges {dtype} packed={packed}")
            if not bool(torch.isnan(got[0][-1])):
                raise AssertionError(f"K3 {name} edges: NaN query gave {got[0][-1]}")
    log(f"K3 {name} edges: faces, outside and NaN agree (f32, f64, "
        f"{', '.join('packed' if p else 'raw' for p in packings)})")


def _grid_sample_ms(sdf, pts):
    """Call rate (cuda_ms: CUDA events over 20 back-to-back calls) of
    F.grid_sample's trilinear distance (no gradient) at the same queries:
    a yardstick only, no function of the port's."""
    import torch
    import torch.nn.functional as F

    nz, rows, cols = sdf.grid
    size = torch.tensor([cols - 1, rows - 1, nz - 1], dtype=pts.dtype, device=pts.device)
    g = (2 * (pts - sdf.origin) / sdf.cell_size / size - 1).reshape(1, 1, 1, -1, 3)
    vol = sdf.data[None, None]
    return cuda_ms(lambda: F.grid_sample(vol, g, mode="bilinear", align_corners=True), 20)


def _grid_sample_2d_ms(sdf, pts, qpw=0):
    """Device time (device_ms, L2 flushed: median, min, max) of
    F.grid_sample's bilinear distance (no gradient) at planar queries
    (N, >= 2), one image a world where qpw > 0: a yardstick only, no
    function of the port's."""
    import torch
    import torch.nn.functional as F

    rows, cols = sdf.grid
    W = max(sdf.num_worlds, 1)
    size = torch.tensor([cols - 1, rows - 1], dtype=pts.dtype, device=pts.device)
    g = (2 * (pts[:, :2] - sdf.origin) / sdf.cell_size / size - 1).reshape(W, 1, -1, 2)
    vol = sdf.data.reshape(W, 1, rows, cols)
    return device_ms(lambda: F.grid_sample(vol, g, mode="bilinear", align_corners=True),
                     flush=True)


def wam_desk_sdf(dev):
    """The WAMDeskDataset 300^3 SDF in float32 on `dev` (unpacked)."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy

    ds = generate_3d_dataset("WAMDeskDataset")
    t0 = time.perf_counter()
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=torch.float32, device=dev)
    log(f"SDF {tuple(sdf.data.shape)} {sdf.data.dtype} on {sdf.data.device}, "
        f"{sdf.data.numel() * sdf.data.element_size() / 1e6:.1f} MB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return sdf


def main_path_endpoints(robot, sdf, B, seed=0):
    """bench.py's endpoints: perturbations of WAMPlannerExample.m's start and
    goal by 0.05 N(0, 1) (numpy `seed`), rejection-sampled in batches of 2 B
    so that every pinned endpoint is collision-free; (starts, goals), (B, 7)
    in the robot's dtype on the SDF's device."""
    import torch
    from gpmp2_tpu_torch.obstacle.factors import obstacle_factor_error

    rng = np.random.default_rng(seed)
    dtype, dev = sdf.data.dtype, sdf.data.device

    def sample_feasible(base, n):
        out = []
        while len(out) < n:
            cand = base + 0.05 * rng.normal(size=(2 * n, 7))
            q = torch.as_tensor(cand, dtype=dtype, device=dev)
            free = (obstacle_factor_error(robot, sdf, q, 0.0).sum(-1) < 1e-6).cpu().numpy()
            out.extend(cand[free][: n - len(out)])
        return np.stack(out)

    starts = torch.as_tensor(sample_feasible(BASE_START, B), dtype=dtype, device=dev)
    goals = torch.as_tensor(sample_feasible(BASE_GOAL, B), dtype=dtype, device=dev)
    return starts, goals


def main_path_inputs(dev, B=None, seed=0, sdf=None):
    """The main path's robot, SDF (`sdf`, else wam_desk_sdf), setting,
    optimizer parameters, and B (default B_MAIN) start and goal
    configurations (main_path_endpoints from numpy `seed`; float32 on
    `dev`)."""
    import torch
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting
    from gpmp2_tpu_torch.robots import generate_arm

    robot = generate_arm("WAMArm", dtype=torch.float32, device=dev)
    sdf = wam_desk_sdf(dev) if sdf is None else sdf
    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=9, opt_type="lm", max_iter=50, rel_thresh=1e-2,
        Qc=np.eye(7))
    params = optimizer_params_from_setting(setting)
    starts, goals = main_path_endpoints(robot, sdf, B_MAIN if B is None else B, seed)
    return robot, sdf, setting, params, starts, goals


def main_path_queries(robot, sdf, setting, starts, goals):
    """The SDF queries of the main path's first linearize: K2's sphere
    centres of every collision state of the straight-line init, (N, 3)."""
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_batched
    from gpmp2_tpu_torch.planner import init_traj_straight_line
    from gpmp2_tpu_torch.planner.batch import make_problem
    from gpmp2_tpu_torch.planner.problem import _collision_confs

    import torch

    z = torch.zeros_like(starts)
    probs = make_problem(robot, sdf, starts, z, goals, z, setting, sdf_pack=False)
    init = init_traj_straight_line(probs.space, starts, goals, setting.total_step,
                                   setting.total_time)
    centers, _ = arm_fk_spheres_batched(robot, _collision_confs(probs, *init))
    return centers.reshape(-1, 3).contiguous()


def reset_launches():
    from gpmp2_tpu_torch.utils import trace

    trace.reset_counters()


def read_launches():
    """K1-K3's and the assembly kernel's launches since `reset_launches`,
    from the port's counters
    (gpmp2_tpu_torch/utils/trace.py)."""
    from gpmp2_tpu_torch.utils import trace

    c = trace.counters()
    return {"btsolve": c["launches.k1"], "fk_arm": c["launches.k2"],
            "sdf_lookup": c["launches.k3"], "assemble": c["launches.assemble"]}


def path_solver(inputs, params, fetch=False):
    """solve(b): the first b main-path problems built through the entry
    points (on the SDF packed once), planned from the straight line with
    `params`, and their collision costs, ending in a synchronize; with
    `fetch`, ending instead in a host copy of what a caller uses (the
    trajectory, error, iterations, converged and gave_up, the collision
    costs), which it returns."""
    import torch
    from gpmp2_tpu_torch.planner import (collision_cost, init_traj_straight_line,
                                         make_problem, plan_batch)
    from gpmp2_tpu_torch.planner.problem import Trajectory
    from gpmp2_tpu_torch.solver.optimize import OptResult

    robot, sdf, setting, _, starts, goals = inputs
    zeros = torch.zeros_like(starts)
    # make_problem packs the field under its budget; pack it once here so
    # that the timed solves reuse the table
    packed = make_problem(robot, sdf, starts[:1], zeros[:1], goals[:1], zeros[:1],
                          setting).sdf
    if packed.packed is None:
        raise AssertionError("make_problem did not pack the main path's SDF")

    def solve(b):
        probs = make_problem(robot, packed, starts[:b], zeros[:b], goals[:b], zeros[:b],
                             setting)
        init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                       setting.total_step, setting.total_time)
        res = plan_batch(probs, init, params)
        cc = collision_cost(probs, res.traj.pose)
        if fetch:
            return OptResult(Trajectory(res.traj.pose.cpu(), res.traj.vel.cpu()),
                             *(t.cpu() for t in res[1:])), cc.cpu()
        sync()
        return res, cc
    solve.sdf = packed
    solve.device = starts.device
    return solve


class MainPathRun(NamedTuple):
    times: list  # seconds of each timed solve
    res: object  # the last solve's result
    cc: object  # its collision costs
    launches: dict  # its launches
    warmup_s: float


def timed_main_path(name, solve, B=None, repeats=None):
    """The main path's protocol: a warm-up, then `repeats` (default
    REPEATS) timed solves of B (default B_MAIN) problems, each of which
    must launch K1, K2, K3 and the assembly kernel on the card, the last
    once a linearize, as often as K2 (on the CPU the wrappers run their
    plain versions and count nothing)."""
    B = B_MAIN if B is None else B
    t0 = time.perf_counter()
    solve(B)  # warm-up
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS if repeats is None else repeats):
        reset_launches()
        t0 = time.perf_counter()
        res, cc = solve(B)
        times.append(time.perf_counter() - t0)
        launches = read_launches()
        if solve.device.type == "cuda" and min(launches.values()) == 0:
            raise AssertionError(f"a kernel was not launched by the {name}: {launches}")
        if launches["assemble"] != launches["fk_arm"]:
            raise AssertionError(f"the {name} did not launch the assembly kernel once a "
                                 f"linearize: {launches}")
    return MainPathRun(times, res, cc, launches, warmup_s)


def warm_latency_ms(solve, b, repeats=None):
    """A warm-up solve(b), then `repeats` (default REPEATS) timed ones: their
    milliseconds."""
    solve(b)
    times = []
    for _ in range(REPEATS if repeats is None else repeats):
        t0 = time.perf_counter()
        solve(b)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main_path_quality(name, res, cc):
    """The converged (and not given up) and collision-free masks and the
    fractions the main path gates on: converged 0.95, collision-free among
    the converged 0.99."""
    conv = (res.converged & ~res.gave_up).cpu().numpy()
    free = (cc < 1e-4).cpu().numpy()
    converged_frac = float(conv.mean())
    collision_free_frac = float(free[conv].mean()) if conv.any() else 0.0
    if converged_frac < 0.95:
        raise AssertionError(f"{name}: converged_frac {converged_frac} < 0.95")
    if collision_free_frac < 0.99:
        raise AssertionError(f"{name}: collision-free among converged {collision_free_frac} "
                             f"< 0.99")
    return conv, free, converged_frac, collision_free_frac


def main_path_result(name, res, cc, B):
    """The main path's result checks: a finite trajectory of shape (B, 11, 7),
    finite errors and collision costs, and main_path_quality's gates."""
    import torch

    for part, t in (("pose", res.traj.pose), ("vel", res.traj.vel),
                    ("error", res.error), ("collision cost", cc)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite {part} in the result")
    if res.traj.pose.shape != (B, 11, 7):
        raise AssertionError(f"{name}: trajectory shape {tuple(res.traj.pose.shape)}")
    return main_path_quality(name, res, cc)


def main_path(dev, card, inputs):
    """Phase 6; returns its JSON line's metrics."""
    solve = path_solver(inputs, inputs[3])
    run = timed_main_path("main path", solve)
    t_solve, res = min(run.times), run.res
    conv, free, converged_frac, collision_free_frac = main_path_result("main path", res,
                                                                       run.cc, B_MAIN)
    gave = res.gave_up.cpu().numpy()
    metrics = {
        "metric": "wam7_lm_main_path", "batch": B_MAIN,
        "converged_frac": converged_frac,
        "gave_up_frac": float(gave.mean()),
        "collision_free_frac": collision_free_frac,
        "mean_iters": float(res.iterations.float().mean()),
        "solve_time_s": t_solve,
        "plans_per_s": float((conv & free).sum()) / t_solve,
        "latency_b1_ms": min(warm_latency_ms(solve, 1)),
        "latency_b32_ms": min(warm_latency_ms(solve, 32)),
        "launches": run.launches,
        "card": card,
    }
    log(json.dumps(metrics))
    return metrics


def _card_vs_cpu(dev, name, build, params):
    """build(where) -> (problems, initial trajectory) in float64 on `where`:
    the linearize of the initial trajectory and the plan, on the card
    (kernels) against the CPU (plain versions), on identical inputs."""
    import torch
    from gpmp2_tpu_torch.planner import plan_batch, traj_linearize

    out = []
    for where in (dev, torch.device("cpu")):
        probs, init = build(where)
        lin = [t.cpu() for t in traj_linearize(probs, init)]
        res = plan_batch(probs, init, params)
        out.append((lin, res.error.cpu(), res.converged.cpu()))
    (lin_c, err_c, conv_c), (lin_p, err_p, conv_p) = out
    for part, a, b in zip(("H_diag", "H_off", "b", "err"), lin_c, lin_p):
        d = float((a - b).abs().max())
        if not d <= 1e-9 * float(b.abs().max()):
            raise AssertionError(f"{name}: linearize {part}: card vs CPU max|d| {d}")
    rel = float(((err_c - err_p).abs() / err_p.abs()).max())
    log(f"reference {name} (f64, B={err_c.shape[0]}): linearize agrees; final error rel "
        f"diff {rel:.3e}, converged card {conv_c.tolist()} cpu {conv_p.tolist()}")
    if not (rel <= 1e-6 and bool((conv_c == conv_p).all())):
        raise AssertionError(f"{name}: card and CPU plans disagree")


def reference_agreement(dev, inputs):
    """Float64, card against CPU: four main-path problems (raw field) under
    LM and under Dogleg, and four MobileBaseSE2 problems under LM."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting
    from gpmp2_tpu_torch.robots import generate_arm, generate_mobile_base

    _, sdf, setting, params, starts, goals = inputs
    f64 = torch.float64

    def wam(where):
        s = starts[:4].to(device=where, dtype=f64)
        g = goals[:4].to(device=where, dtype=f64)
        z = torch.zeros_like(s)
        probs = make_problem(generate_arm("WAMArm", dtype=f64, device=where),
                             sdf.to(dtype=f64, device=where), s, z, g, z, setting,
                             sdf_pack=False)
        return probs, init_traj_straight_line(probs.space, s, g, setting.total_step,
                                              setting.total_time)

    _card_vs_cpu(dev, "WAM LM", wam, params)
    _card_vs_cpu(dev, "WAM Dogleg", wam, dataclasses.replace(params, method="dogleg"))

    ds = generate_2d_dataset("MobileMap1")
    setting_m = mobile_setting()
    s_m, g_m = draw_mobile(np.random.default_rng(0), 4)

    def mobile(where):
        s, g = (torch.as_tensor(x, dtype=f64, device=where) for x in (s_m, g_m))
        z = torch.zeros_like(s)
        probs = make_problem(
            generate_mobile_base(dtype=f64, device=where),
            planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=f64,
                                      device=where),
            s, z, g, z, setting_m, sdf_pack=False, **MOBILE_KW)
        return probs, init_traj_straight_line(probs.space, s, g, setting_m.total_step,
                                              setting_m.total_time)

    _card_vs_cpu(dev, "MobileBaseSE2 LM", mobile, optimizer_params_from_setting(setting_m))


# bench_suite.py's MobileBaseSE2 config: problem keywords, setting, draws
MOBILE_KW = {"flag_vehicle_dynamics": True, "dyn_sigma": 0.001}


def mobile_setting():
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting

    return TrajOptimizerSetting(dof=3, total_step=15, total_time=15.0, cost_sigma=0.01,
                                obs_check_inter=3, opt_type="lm", max_iter=50,
                                rel_thresh=1e-2, Qc=np.eye(3))


def draw_mobile(r, n):
    """(starts, goals) as numpy (n, 3), in bench_suite.py's draw order."""
    s = np.stack([r.uniform(-3.5, -2.5, n), r.uniform(-3.5, -2.5, n),
                  r.uniform(-0.5, 0.5, n)], -1)
    g = np.stack([r.uniform(2.5, 3.5, n), r.uniform(2.5, 3.5, n),
                  r.uniform(1.0, 2.0, n)], -1)
    return s, g


def suite_configs(dev, wam_sdf, batch=None, seed_t=1):
    """bench_suite.py's configurations and draws, in its order: for each
    config, (name, robot, setting, (q512 sdf, starts, goals), (throughput
    sdf, starts, goals), make_problem keywords). numpy seed 0 draws the
    oracle's 512-problem sets, seed `seed_t` the throughput batches; `batch`
    (default SUITE_BATCH) holds the sizes, keyed as SUITE_BATCH."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.kinematics.fk import PointRobotFK
    from gpmp2_tpu_torch.kinematics.robot import make_robot_model
    from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting
    from gpmp2_tpu_torch.robots import generate_arm, generate_mobile_base

    f32 = torch.float32
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=f32, device=dev)  # noqa: E731
    rng, rng_t = np.random.default_rng(0), np.random.default_rng(seed_t)
    sizes = SUITE_BATCH if batch is None else batch
    Bq = sizes["q512"]
    out = []

    ds = generate_2d_dataset("OneObstacleDataset")
    sdf2 = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    robot = make_robot_model(PointRobotFK(), [(0, 0.08, (0.0, 0.0, 0.0))], device=dev)
    setting = TrajOptimizerSetting(dof=2, total_step=10, total_time=10.0, cost_sigma=0.1,
                                   obs_check_inter=5, opt_type="lm", max_iter=50,
                                   rel_thresh=1e-2, Qc=np.eye(2))

    def draw_pr(r, n):
        s = np.stack([r.uniform(-0.9, -0.5, n), r.uniform(-0.9, 0.0, n)], -1)
        g = np.stack([r.uniform(1.4, 1.8, n), r.uniform(1.2, 1.8, n)], -1)
        return t(s), t(g)
    out.append(("PointRobot2D", robot, setting, (sdf2, *draw_pr(rng, Bq)),
                (sdf2, *draw_pr(rng_t, sizes["PointRobot2D"])), {}))

    dsm = generate_2d_dataset("MobileMap1")
    sdfm = planar_sdf_from_occupancy(dsm.origin, dsm.cell_size, dsm.map, device=dev)
    out.append(("MobileBaseSE2", generate_mobile_base(device=dev), mobile_setting(),
                (sdfm, *map(t, draw_mobile(rng, Bq))),
                (sdfm, *map(t, draw_mobile(rng_t, sizes["MobileBaseSE2"]))),
                MOBILE_KW))

    arm3 = generate_arm("SimpleThreeLinksArm", device=dev)
    setting_a = TrajOptimizerSetting(
        dof=3, total_step=10, total_time=5.0, cost_sigma=0.1, obs_check_inter=5,
        opt_type="lm", max_iter=50, rel_thresh=1e-2, Qc=np.eye(3),
        flag_pos_limit=True, flag_vel_limit=True,
        joint_pos_limits_down=-np.pi * np.ones(3), joint_pos_limits_up=np.pi * np.ones(3),
        vel_limits=1.5 * np.ones(3))

    def draw_a3(r, n):
        s = 0.2 * r.normal(size=(n, 3))
        g = np.array([np.pi / 2, 0, 0]) + 0.2 * r.normal(size=(n, 3))
        return t(s), t(g)
    out.append(("Arm3Limits2D", arm3, setting_a, (sdf2, *draw_a3(rng, Bq)),
                (sdf2, *draw_a3(rng_t, sizes["Arm3Limits2D"])), {}))

    wam = generate_arm("WAMArm", device=dev)
    setting_w = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, cost_sigma=0.02, obs_check_inter=9,
        opt_type="lm", max_iter=50, rel_thresh=1e-2, Qc=np.eye(7))

    def draw_w(r, n):
        return (t(BASE_START + 0.03 * r.normal(size=(n, 7))),
                t(BASE_GOAL + 0.03 * r.normal(size=(n, 7))))
    out.append(("WAM7_3D", wam, setting_w, (wam_sdf, *draw_w(rng, Bq)),
                (wam_sdf, *draw_w(rng_t, sizes["WAM7_3D"])), {}))

    n = 64
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    pr = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))], device=dev)
    setting_mw = TrajOptimizerSetting(dof=2, total_step=8, total_time=4.0, cost_sigma=0.1,
                                      obs_check_inter=3, opt_type="lm", max_iter=50,
                                      rel_thresh=1e-2, Qc=np.eye(2))

    def draw_mw(r, nn):
        cys = r.uniform(-0.3, 0.3, nn)
        data = np.stack([np.sqrt(X**2 + (Y - c) ** 2) - 0.3 for c in cys])
        sdf = PlanarSDF(t([-1.5, -1.5]), t(3.0 / (n - 1)), t(data))
        s = np.stack([np.full(nn, -0.9), r.uniform(-0.3, 0.3, nn)], -1)
        g = np.stack([np.full(nn, 0.9), r.uniform(-0.3, 0.3, nn)], -1)
        return sdf, t(s), t(g)
    out.append(("MultiWorld2D", pr, setting_mw, draw_mw(rng, Bq),
                draw_mw(rng_t, sizes["MultiWorld2D"]), {}))
    return out


def suite_measure(robot, setting, qset, tset, kwargs, repeats=None):
    """bench_suite.py's protocol for one config of suite_configs: the q512
    set solved once with the float64 rescue on; then the throughput set
    once as a warm-up and `repeats` (default REPEATS) timed times, rescue
    off, each timed to a host copy of its converged (and not given up),
    gave_up and collision-free masks and mean iterations. Returns a dict:
    `q512` (converged, collision-free), `warmup_s`, `times` (seconds),
    `last` (the last solve's four columns) and `launches` (its launches)."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.planner import (collision_cost, init_traj_straight_line,
                                         make_problem, plan_batch)
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting

    params = optimizer_params_from_setting(setting)

    def prepare(sdf, s, g):
        z = torch.zeros_like(s)
        probs = make_problem(robot, sdf, s, z, g, z, setting, **kwargs)
        init = init_traj_straight_line(probs.space, s, g, setting.total_step,
                                       setting.total_time)
        return probs, init

    def run(probs, init, p):
        t0 = time.perf_counter()
        res = plan_batch(probs, init, p)
        cc = collision_cost(probs, res.traj.pose)
        conv = (res.converged & ~res.gave_up).cpu().numpy()
        out = (conv, res.gave_up.cpu().numpy(), (cc < 1e-4).cpu().numpy(),
               res.iterations.float().mean().item())
        return time.perf_counter() - t0, out

    probs_q, init_q = prepare(*qset)
    _, (conv_q, _, free_q, _) = run(probs_q, init_q,
                                    dataclasses.replace(params, rescue_f64=True))
    probs_t, init_t = prepare(*tset)
    warmup_s, _ = run(probs_t, init_t, params)
    times = []
    for _ in range(REPEATS if repeats is None else repeats):
        reset_launches()
        t_run, last = run(probs_t, init_t, params)
        times.append(t_run)
        launches = read_launches()
    return {"q512": (conv_q, free_q), "warmup_s": warmup_s, "times": times, "last": last,
            "launches": launches}


def suite_gates(name, row, on_card=True):
    """A suite row's gates: K1 and K3 launched (K2 too in the arm configs)
    where it ran on the card; where the row holds the oracle's fractions
    (its q512 set is the oracle's), its q512 converged fraction not below
    the oracle's and its q512 collision-free fraction within 0.02 of it."""
    launches = row["launches"]
    need = ["btsolve", "sdf_lookup"] + (["fk_arm"] if name in ("Arm3Limits2D", "WAM7_3D")
                                        else [])
    if on_card and any(launches[k] == 0 for k in need):
        raise AssertionError(f"{name}: a kernel of its path was not launched: {launches}")
    if row["oracle_q512_converged_frac"] is None:
        return
    if row["q512_converged_frac"] < row["oracle_q512_converged_frac"]:
        raise AssertionError(f"{name}: q512 converged {row['q512_converged_frac']} < "
                             f"the oracle's {row['oracle_q512_converged_frac']}")
    if abs(row["q512_collision_free_frac"] - row["oracle_q512_collision_free_frac"]) > 0.02:
        raise AssertionError(f"{name}: q512 collision-free "
                             f"{row['q512_collision_free_frac']} not within 0.02 of "
                             f"the oracle's {row['oracle_q512_collision_free_frac']}")


def oracle_suite_quality():
    """BASELINE_MEASURED_SUITE.json's configs: the oracle's results on the
    512-problem sets (its quality columns do not depend on the host)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BASELINE_MEASURED_SUITE.json")) as fh:
        return json.load(fh)["configs"]


def suite(dev, card, wam_sdf):
    """The bench_suite.py paths, each config's line and gates; returns the
    lines by config."""
    oracles = oracle_suite_quality()
    rows = {}
    for name, robot, setting, qset, tset, kwargs in suite_configs(dev, wam_sdf):
        m = suite_measure(robot, setting, qset, tset, kwargs)
        (conv_q, free_q), (conv, gave, free, iters) = m["q512"], m["last"]
        best = min(m["times"])
        oracle = oracles[name]
        row = {
            "config": name, "batch": int(conv.shape[0]),
            "plans_per_s": float((conv & free).sum()) / best, "solve_s": best,
            "converged_frac": float(conv.mean()), "gave_up_frac": float(gave.mean()),
            "collision_free_frac": float(free.mean()), "mean_iters": iters,
            "q512_converged_frac": float(conv_q.mean()),
            "q512_collision_free_frac": float(free_q.mean()), "q512_rescue_f64": True,
            "oracle_q512_converged_frac": oracle["converged"] / 512,
            "oracle_q512_collision_free_frac": oracle["collision_free"] / 512,
            "launches": m["launches"], "card": card,
        }
        log(json.dumps(row))
        suite_gates(name, row)
        rows[name] = row
    return rows


def dogleg_phase(card, inputs):
    """Dogleg on the main path's B_MAIN problems, float32: best of
    REPEATS after a warm-up; K1, K2 and K3 must launch and every lane's
    final trajectory must be finite. Quality is printed, not gated."""
    import dataclasses

    import torch

    solve = path_solver(inputs, dataclasses.replace(inputs[3], method="dogleg"))
    solve(B_MAIN)  # warm-up
    best = float("inf")
    for _ in range(REPEATS):
        reset_launches()
        t0 = time.perf_counter()
        res, cc = solve(B_MAIN)
        best = min(best, time.perf_counter() - t0)
        launches = read_launches()
        if min(launches.values()) == 0:
            raise AssertionError(f"Dogleg: a kernel of its path was not launched: {launches}")
    for name, x in (("pose", res.traj.pose), ("vel", res.traj.vel)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"Dogleg: non-finite final {name}")
    conv = (res.converged & ~res.gave_up).cpu().numpy()
    free = (cc < 1e-4).cpu().numpy()
    # as the main path's line: collision-free among the converged lanes
    log(json.dumps({
        "metric": "wam7_dogleg_main_path", "batch": B_MAIN,
        "plans_per_s": float((conv & free).sum()) / best, "solve_time_s": best,
        "converged_frac": float(conv.mean()), "gave_up_frac": float(res.gave_up.float().mean()),
        "collision_free_frac": float(free[conv].mean()) if conv.any() else 0.0,
        "mean_iters": float(res.iterations.float().mean()),
        "launches": launches, "card": card,
    }))


# phase 10: the mobile manipulators. PR2 (18 dof, 65 spheres, two arms and
# a torso lift) with its left forearm and gripper spheres (24-41, links 6
# and 8) against the right's (47-64, links 13 and 15): 324 pairs, eps 0.02,
# sigma 0.05
B_PR2 = 2048
PR2_PAIRS = [(a, b, 0.02, 0.05) for a in range(24, 42) for b in range(47, 65)]
PR2_KW = {"flag_vehicle_dynamics": True, "dyn_sigma": 1e-3,
          "self_collision_pairs": PR2_PAIRS}
B_TWO_LINKS = 4096
F64_FLOPS = 67e12  # FP64 on the tensor cores, H100 SXM (NVIDIA's data sheet)


def check_btsolve_m36(dev):
    """K1 at the PR2's block size m = 36 (B = B_PR2, n = 11), float32 and
    float64, damped and lambda = 0, against the plain version in float64 on
    the same rounded inputs, with check_btsolve's tolerances; the damped
    solves are timed with their bounds."""
    import torch
    from gpmp2_tpu_torch.ops.btsolve import (block_tridiag_solve_cuda,
                                             block_tridiag_solve_torch, launch_plan)
    from gpmp2_tpu_torch.testing import random_system

    B, n, m = B_PR2, 11, 36
    out = {}
    for dtype, tol, peak in ((torch.float32, 1e-4, F32_FLOPS), (torch.float64, 1e-10, F64_FLOPS)):
        name = "f32" if dtype == torch.float32 else "f64"
        for damped in (True, False):
            D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=dev)
                            for a in random_system(B, n, m, seed=36 + damped, damped=damped,
                                                   conditioned=True))
            x = block_tridiag_solve_cuda(D, U, b, True, lam)
            torch.cuda.synchronize()
            x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(), True,
                                              lam.double())
            err, scale = float((x.double() - x_ref).abs().max()), float(x_ref.abs().max())
            log(f"K1 m=36 {name} damped={damped}: B={B} n={n} max|dx|={err:.3e} "
                f"max|x|={scale:.3e}")
            if not err <= tol * scale:
                raise AssertionError(f"K1 m=36 {name} damped={damped}: max|dx| {err} > "
                                     f"{tol} * {scale}")
            if damped:
                ms = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 20)
                bound_ms, bound_by = k1_bound(B, n, m, D.element_size(), peak)
                threads, smem = launch_plan(m, dtype)
                log(f"K1 time at B={B} n={n} m={m} {name}: kernel {ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}); {threads} threads, {smem} B shared "
                    "memory per block")
                out[f"ms_m36_{name}"] = ms
                out[f"bound_ms_m36_{name}"] = bound_ms
    return out


def pr2_setting(total_step=10, inter=4):
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting

    return TrajOptimizerSetting(dof=18, total_step=total_step, total_time=5.0,
                                obs_check_inter=inter, cost_sigma=0.02, epsilon=0.05,
                                opt_type="lm", max_iter=50, rel_thresh=1e-2, Qc=np.eye(18))


def pr2_inputs(dev, sdf):
    """PR2 (float32 on `dev`) and B_PR2 start and goal configurations in the
    main path's field: numpy seed 0, rejection-sampled so that every
    endpoint's obstacle and self-collision errors at eps 0 are zero."""
    import torch
    from gpmp2_tpu_torch.obstacle.factors import obstacle_factor_error, self_collision_error
    from gpmp2_tpu_torch.robots import generate_mobile_arm

    f32 = torch.float32
    robot = generate_mobile_arm("PR2", dtype=f32, device=dev)
    pairs = torch.as_tensor([p[:2] for p in PR2_PAIRS], device=dev)
    no_eps = torch.zeros(len(PR2_PAIRS), dtype=f32, device=dev)
    rng = np.random.default_rng(0)

    def sample(n, x_range, lift_max):
        out = []
        while len(out) < n:
            k = 2 * n
            cand = np.concatenate([
                rng.uniform(*x_range, (k, 1)), rng.uniform(-0.4, 0.0, (k, 1)),
                rng.uniform(-0.3, 0.3, (k, 1)),
                rng.uniform(0.0, lift_max, (k, 1)) if lift_max else np.zeros((k, 1)),
                0.3 * rng.normal(size=(k, 14))], 1)
            q = torch.as_tensor(cand, dtype=f32, device=dev)
            err = (obstacle_factor_error(robot, sdf, q, 0.0).sum(-1)
                   + self_collision_error(robot, q, pairs[:, 0], pairs[:, 1], no_eps).sum(-1))
            out.extend(cand[(err < 1e-6).cpu().numpy()][: n - len(out)])
        return torch.as_tensor(np.stack(out), dtype=f32, device=dev)

    return robot, sample(B_PR2, (-1.0, -0.6), 0.0), sample(B_PR2, (-0.3, 0.0), 0.2)


def mobile_row(metric, solve, b, card):
    """Best of REPEATS `solve(b)` after a warm-up: the row's JSON line
    (collision-free and self-collision-free among the converged lanes).
    Gates: K1 and K3 launched in every timed solve, every final
    trajectory finite."""
    import torch

    solve(b)  # warm-up
    best = float("inf")
    for _ in range(REPEATS):
        reset_launches()
        t0 = time.perf_counter()
        res, cc, scc = solve(b)
        best = min(best, time.perf_counter() - t0)
        launches = read_launches()
        if launches["btsolve"] == 0 or launches["sdf_lookup"] == 0:
            raise AssertionError(f"{metric}: a kernel of its path was not launched: {launches}")
    for name, x in (("pose", res.traj.pose), ("vel", res.traj.vel)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{metric}: non-finite final {name}")
    conv = (res.converged & ~res.gave_up).cpu().numpy()
    free = (cc < 1e-4).cpu().numpy()
    row = {"metric": metric, "batch": b,
           "plans_per_s": float((conv & free).sum()) / best, "solve_time_s": best,
           "converged_frac": float(conv.mean()),
           "gave_up_frac": float(res.gave_up.float().mean()),
           "collision_free_frac": float(free[conv].mean()) if conv.any() else 0.0}
    if scc is not None:
        sfree = (scc < 1e-4).cpu().numpy()
        row["self_collision_free_frac"] = float(sfree[conv].mean()) if conv.any() else 0.0
    row.update({"mean_iters": float(res.iterations.float().mean()), "launches": launches,
                "card": card})
    log(json.dumps(row))


def pr2_solver(robot, sdf, starts, goals, setting):
    """solve(b): the first b PR2 problems built through the entry points on
    the SDF packed once, planned from the straight line under LM, and
    their obstacle and self-collision costs, ending in a synchronize."""
    import torch
    from gpmp2_tpu_torch.planner import (collision_cost, init_traj_straight_line,
                                         make_problem, optimizer_params_from_setting,
                                         plan_batch, self_collision_cost)

    zeros = torch.zeros_like(starts)
    packed = make_problem(robot, sdf, starts[:1], zeros[:1], goals[:1], zeros[:1], setting,
                          **PR2_KW).sdf
    if packed.packed is None:
        raise AssertionError("make_problem did not pack the PR2's SDF")
    params = optimizer_params_from_setting(setting)

    def solve(b):
        probs = make_problem(robot, packed, starts[:b], zeros[:b], goals[:b], zeros[:b],
                             setting, **PR2_KW)
        init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                       setting.total_step, setting.total_time)
        res = plan_batch(probs, init, params)
        cc = collision_cost(probs, res.traj.pose)
        scc = self_collision_cost(probs, res.traj.pose)
        torch.cuda.synchronize()
        return res, cc, scc
    return solve


def replan_world(name, dev, dtype):
    """tests/fixtures/oracle_replan_{name}.npz, its robot (the point robot
    of radius 0.15, or SimpleTwoLinksArm), its one-box 300^2 planar field
    and its graph: 10 intervals, the fixture's interpolated states, cost
    sigma and eps, LM at the fixture's rel_tol."""
    from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
    from gpmp2_tpu_torch.kinematics.fk import PointRobotFK
    from gpmp2_tpu_torch.kinematics.robot import make_robot_model
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting
    from gpmp2_tpu_torch.robots import generate_mobile_arm

    here = os.path.dirname(os.path.abspath(__file__))
    fx = np.load(os.path.join(here, "tests", "fixtures", f"oracle_replan_{name}.npz"))
    occ = np.zeros((300, 300))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    sdf = planar_sdf_from_occupancy(fx["meta_origin"], float(fx["meta_cell"]), occ,
                                    dtype=dtype, device=dev)
    if name == "pointrobot2d":
        robot = make_robot_model(PointRobotFK(), [(0, 0.15, (0.0, 0.0, 0.0))], dtype=dtype,
                                 device=dev)
    else:
        robot = generate_mobile_arm("SimpleTwoLinksArm", dtype=dtype, device=dev)
    setting = TrajOptimizerSetting(
        dof=robot.dof, total_step=int(fx["meta_n_steps"]),
        total_time=float(fx["meta_total_time"]), obs_check_inter=int(fx["meta_inter"]),
        cost_sigma=float(fx["meta_cost_sigma"]), epsilon=float(fx["meta_eps"]),
        opt_type="lm", max_iter=100, rel_thresh=float(fx["meta_rel_tol"]))
    return fx, robot, sdf, setting


def two_links_draws(fx, dev):
    """The throughput row's B_TWO_LINKS starts and goals (float32): the
    fixture's start and goal each perturbed by 0.05 N(0, 1), numpy seed 1."""
    import torch

    rng = np.random.default_rng(1)
    s = torch.as_tensor(fx["meta_start"] + 0.05 * rng.normal(size=(B_TWO_LINKS, 5)),
                        dtype=torch.float32, device=dev)
    g = torch.as_tensor(fx["meta_goal0"] + 0.05 * rng.normal(size=(B_TWO_LINKS, 5)),
                        dtype=torch.float32, device=dev)
    return s, g


def check_mobile_lookups(dev, wam_sdf, pr2):
    """K3 against its plain version (check_lookup) at the queries of phase
    10's two rows: the sphere centres of every collision state of the
    straight-line init, the PR2's (B_PR2 x 51 states x 65 spheres) in the
    main path's 300^3 field and SimpleTwoLinksArm's (B_TWO_LINKS x 11
    states x 10 spheres) in the one-box 300^2 field, each packed in
    float32 as its row runs it and raw in float64; K3 timed at the PR2's."""
    import torch
    from gpmp2_tpu_torch.kinematics.robot import sphere_centers_world
    from gpmp2_tpu_torch.obstacle.sdf import pack_planar_sdf, pack_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem
    from gpmp2_tpu_torch.planner.problem import _collision_confs

    def queries(robot, sdf, setting, s, g, **kw):
        z = torch.zeros_like(s)
        probs = make_problem(robot, sdf, s, z, g, z, setting, sdf_pack=False, **kw)
        init = init_traj_straight_line(probs.space, s, g, setting.total_step,
                                       setting.total_time)
        confs = _collision_confs(probs, *init)
        return sphere_centers_world(robot, confs).reshape(-1, 3).contiguous()

    robot, starts, goals = pr2
    pts = queries(robot, wam_sdf, pr2_setting(), starts, goals, **PR2_KW)
    packed = pack_sdf(wam_sdf)
    check_lookup("PR2 packed f32", packed, pts, True)
    check_lookup("PR2 raw f64", wam_sdf.to(dtype=torch.float64), pts.double(), False)
    ms = cuda_ms(lambda: sdf_lookup_cuda(pts, *_lookup_operands(packed, True)), 20)
    log(f"K3 time at N={pts.shape[0]} f32 packed (PR2 row): kernel {ms:.4f} ms")
    del packed

    fx, robot, sdf, setting = replan_world("mobilearm", dev, torch.float32)
    pts = queries(robot, sdf, setting, *two_links_draws(fx, dev))
    check_lookup("SimpleTwoLinksArm packed f32", pack_planar_sdf(sdf), pts, True)
    check_lookup("SimpleTwoLinksArm raw f64", sdf.to(dtype=torch.float64), pts.double(),
                 False)


def two_links_phase(dev, card):
    """The oracle's cold LM solve in float64 on the card, from the
    fixture's initial trajectory, within 1% of its final cost; then a
    throughput line at B_TWO_LINKS on the same world, the fixture's start
    and goal each perturbed by 0.05 N(0, 1) (numpy seed 1), float32, LM
    with the bench protocol's max_iter 50 and rel_thresh 1e-2."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.planner import (Trajectory, collision_cost, init_traj_straight_line,
                                         make_problem, optimizer_params_from_setting,
                                         plan_batch)

    fx, robot, sdf, setting = replan_world("mobilearm", dev, torch.float64)
    start = torch.as_tensor(fx["meta_start"], device=dev)[None]
    goal = torch.as_tensor(fx["meta_goal0"], device=dev)[None]
    z = torch.zeros_like(start)
    probs = make_problem(robot, sdf, start, z, goal, z, setting, sdf_pack=False)
    init = Trajectory(torch.as_tensor(fx["init_pose"], device=dev)[None],
                      torch.as_tensor(fx["init_vel"], device=dev)[None])
    res = plan_batch(probs, init, optimizer_params_from_setting(setting))
    cold, oracle = float(res.error[0]), float(fx["cold_final_error"])
    log(f"SimpleTwoLinksArm oracle cold solve (f64, card): error {cold:.6f}, oracle "
        f"{oracle:.6f}, converged {bool(res.converged[0])}, {int(res.iterations[0])} steps")
    if not (bool(res.converged[0]) and cold <= oracle * 1.01 + 1e-9):
        raise AssertionError(f"SimpleTwoLinksArm cold solve {cold} not within 1% of {oracle}")

    fx, robot, sdf, setting = replan_world("mobilearm", dev, torch.float32)
    setting = dataclasses.replace(setting, max_iter=50, rel_thresh=1e-2)
    s, g = two_links_draws(fx, dev)
    params = optimizer_params_from_setting(setting)

    def solve(b):
        zb = torch.zeros_like(s[:b])
        p = make_problem(robot, sdf, s[:b], zb, g[:b], zb, setting)
        res = plan_batch(p, init_traj_straight_line(p.space, s[:b], g[:b], setting.total_step,
                                                    setting.total_time), params)
        cc = collision_cost(p, res.traj.pose)
        torch.cuda.synchronize()
        return res, cc, None

    mobile_row("two_links_lm", solve, B_TWO_LINKS, card)


def pr2_card_vs_cpu(dev, wam_sdf, starts, goals):
    """Float64, card against CPU, on four of the PR2's problems (4
    intervals, 1 interpolated state each, the self-collision pairs, one
    workspace pose slot on link 8 at state 2) and on the same four with
    the end-effector goal in place of the goal prior."""
    import functools

    import torch
    from gpmp2_tpu_torch.geometry import so3
    from gpmp2_tpu_torch.kinematics.fk import link_poses
    from gpmp2_tpu_torch.planner import (init_traj_straight_line, make_problem,
                                         optimizer_params_from_setting, set_workspace_prior)
    from gpmp2_tpu_torch.robots import generate_mobile_arm

    f64 = torch.float64
    setting = pr2_setting(total_step=4, inter=1)
    s_np, g_np = (x[:4].double().cpu().numpy() for x in (starts, goals))
    fk = generate_mobile_arm("PR2", dtype=f64, device="cpu").fk
    mid = link_poses(fk, torch.from_numpy(0.5 * (s_np[0] + g_np[0])))
    ws_point = (mid.trans[8] + torch.tensor([0.05, 0.0, 0.0], dtype=f64)).numpy()
    ws_rot = (mid.rot[8] @ so3.expmap(torch.tensor([0.0, 0.0, 0.3], dtype=f64))).numpy()
    goal_point = link_poses(fk, torch.from_numpy(g_np[0])).trans[-1].numpy()

    def build(where, goal_region):
        s, g = (torch.as_tensor(x, device=where) for x in (s_np, g_np))
        z = torch.zeros_like(s)
        probs = make_problem(generate_mobile_arm("PR2", dtype=f64, device=where),
                             wam_sdf.to(dtype=f64, device=where), s, z, g, z, setting,
                             sdf_pack=False, num_ws=1, goal_region=goal_region,
                             goal_point=goal_point, **PR2_KW)
        probs = set_workspace_prior(probs, 0, 2, 8, point=ws_point, rot=ws_rot)
        return probs, init_traj_straight_line(probs.space, s, g, setting.total_step,
                                              setting.total_time)

    params = optimizer_params_from_setting(setting)
    _card_vs_cpu(dev, "PR2 LM", functools.partial(build, goal_region=False), params)
    _card_vs_cpu(dev, "PR2 goal region LM", functools.partial(build, goal_region=True), params)


def mobile_phase(dev, card, wam_sdf):
    """Phase 10: K1 at m = 36, K3 at the PR2's and SimpleTwoLinksArm's
    queries, the PR2 row, the SimpleTwoLinksArm oracle and throughput rows, and the PR2's card-vs-CPU agreement in float64.
    Returns K1's m = 36 times for the kernels' line."""
    k1_36 = check_btsolve_m36(dev)
    robot, starts, goals = pr2_inputs(dev, wam_sdf)
    check_mobile_lookups(dev, wam_sdf, (robot, starts, goals))
    mobile_row("pr2_lm", pr2_solver(robot, wam_sdf, starts, goals, pr2_setting()), B_PR2, card)
    two_links_phase(dev, card)
    pr2_card_vs_cpu(dev, wam_sdf, starts, goals)
    return k1_36


# phase 11: incremental replanning. bench_replan.py's fleet of WAM
# sessions: B_FLEET sessions, warm updates of FLEET_WARM_ITER steps,
# FLEET_ROUNDS timed rounds after an untimed cold update and warm-up round
B_FLEET = 1024
FLEET_ROUNDS = 8
FLEET_WARM_ITER = 3


def replan_oracle_gates(dev):
    """Both replanning fixtures' event sequences through ISAM2TrajOptimizer
    in float64 on the card, as tests/test_replan_oracle.py replays them: a
    cold solve, then per round fix_config_and_vel and
    change_goal_config_and_vel. Every final cost within 1% of the oracle's,
    every pinned pose within 1e-3."""
    import torch
    from gpmp2_tpu_torch.planner import (ISAM2TrajOptimizer, Trajectory,
                                         init_traj_straight_line)

    for name in ("pointrobot2d", "mobilearm"):
        fx, robot, sdf, setting = replan_world(name, dev, torch.float64)
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        start, goal0 = t(fx["meta_start"]), t(fx["meta_goal0"])
        z = torch.zeros_like(start)
        planner = ISAM2TrajOptimizer(robot, sdf, setting)
        planner.init_factor_graph(start, z, goal0, z)
        if "init_pose" in fx:
            planner.init_values(Trajectory(t(fx["init_pose"]), t(fx["init_vel"])))
        else:
            planner.init_values(init_traj_straight_line(
                robot.space, start, goal0, setting.total_step, setting.total_time))
        planner.update()
        errs, oracle = [float(planner.error)], [float(fx["cold_final_error"])]
        pin_dev = 0.0
        for r in range(fx["pin_idx"].shape[0]):
            idx = int(fx["pin_idx"][r])
            planner.fix_config_and_vel(idx, t(fx["pin_pose"][r]), t(fx["pin_vel"][r]))
            planner.change_goal_config_and_vel(t(fx["goal"][r]), z)
            planner.update()
            errs.append(float(planner.error))
            oracle.append(float(fx["final_error"][r]))
            pin_dev = max(pin_dev, float((planner.values().pose[idx].cpu()
                                          - torch.as_tensor(fx["pin_pose"][r])).abs().max()))
        log(f"replan oracle {name} (f64, card): errors {[f'{e:.6f}' for e in errs]}, "
            f"oracle {[f'{e:.6f}' for e in oracle]}, max pinned-pose deviation {pin_dev:.2e}")
        if not all(e <= o * 1.01 + 1e-9 for e, o in zip(errs, oracle)) or not pin_dev <= 1e-3:
            raise AssertionError(f"replan oracle {name}: errors {errs} vs {oracle}, "
                                 f"pin deviation {pin_dev}")


def replan_card_vs_cpu(dev):
    """Four point-robot sessions on the pointrobot2d fixture's world in
    float64, on the card (kernels) and on the CPU (plain versions), driven
    in lockstep with the same pins read from the CPU's estimate: a cold
    update, then a round that pins state 3 and moves the goals of lanes 1
    and 3, then one that pins state 6, fuses a state estimate at state 7
    and moves every goal. Each update's final errors agree within rel 1e-6
    and its iteration counts are equal."""
    import torch
    from gpmp2_tpu_torch.planner import ISAM2BatchSessions, init_traj_straight_line

    B, cpu = 4, torch.device("cpu")
    rng = np.random.default_rng(2)
    fleets = []
    for where in (dev, cpu):
        fx, robot, sdf, setting = replan_world("pointrobot2d", where, torch.float64)
        if not fleets:
            starts = fx["meta_start"] + 0.05 * rng.normal(size=(B, 2))
            goals = fx["meta_goal0"] + 0.05 * rng.normal(size=(B, 2))
            shift = 0.05 * rng.normal(size=(2, B, 2))
        s, g = (torch.as_tensor(x, device=where) for x in (starts, goals))
        fleet = ISAM2BatchSessions(robot, sdf, setting, B)
        fleet.init_factor_graph(s, torch.zeros_like(s), g, torch.zeros_like(g))
        fleet.init_values(init_traj_straight_line(robot.space, s, g, setting.total_step,
                                                  setting.total_time))
        fleets.append(fleet)
    zeros = np.zeros((B, 2))
    rounds = [[], [("fix", 3), ("goal", [1, 3])], [("fix", 6), ("estimate", 7), ("goal", None)]]
    for r, ops in enumerate(rounds):
        pose, vel = (x.numpy() for x in fleets[1].values())
        for op, arg in ops:
            for fleet in fleets:
                if op == "fix":
                    fleet.fix_config_and_vel(np.full(B, arg), pose[:, arg], vel[:, arg])
                elif op == "estimate":
                    fleet.add_state_estimate(np.full(B, arg), pose[:, arg] + 0.02,
                                             1e-4, vel[:, arg], 1e-4)
                else:
                    fleet.change_goal_config_and_vel(goals + shift[r - 1], zeros, lanes=arg)
        card, plain = (fleet.update() for fleet in fleets)
        rel = float(((card.error.cpu() - plain.error).abs() / plain.error.abs()).max())
        log(f"replan fleet card vs CPU (f64, B={B}) update {r}: final error rel diff "
            f"{rel:.3e}, iterations card {card.iterations.tolist()} cpu "
            f"{plain.iterations.tolist()}")
        if not (rel <= 1e-6 and torch.equal(card.iterations.cpu(), plain.iterations)):
            raise AssertionError(f"replan fleet update {r}: card and CPU disagree")


def wam_fleet_setting():
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting

    return TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=5, opt_type="lm", max_iter=12, rel_thresh=1e-2, Qc=np.eye(7))


def check_fleet_kernels(dev, fleet):
    """K1, K2 and K3 against their plain versions at the shapes of the WAM
    fleet's linearize after its warm-up round (its pins in place): K1 on
    the fleet's own normal equations, damped by LM's first lambda (100)
    and by 0.01, in float32 against float64 on the rounded inputs, rel
    1e-4 of max|x| as phase 3; K2 on every collision state of the
    estimate (1e-5); K3 on their sphere centres in the packed table
    (check_lookup). Each timed at these shapes."""
    import torch
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda, block_tridiag_solve_torch
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda, fk_spheres_torch, structure_arrays
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda
    from gpmp2_tpu_torch.planner import traj_linearize
    from gpmp2_tpu_torch.planner.problem import _collision_confs

    probs, traj = fleet.problems, fleet.values()
    D, U, b, _ = traj_linearize(probs, traj)
    B = b.shape[0]
    for lam_value in (100.0, 0.01):
        lam = torch.full((B,), lam_value, dtype=b.dtype, device=dev)
        x = block_tridiag_solve_cuda(D, U, b, True, lam)
        x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(), True,
                                          lam.double())
        err, scale = float((x.double() - x_ref).abs().max()), float(x_ref.abs().max())
        log(f"K1 WAM fleet: B={B} n={b.shape[1]} m={b.shape[2]} f32 lambda={lam_value} "
            f"max|dx|={err:.3e} max|x|={scale:.3e}")
        if not err <= 1e-4 * scale:
            raise AssertionError(f"K1 WAM fleet lambda {lam_value}: max|dx| {err} > 1e-4 * "
                                 f"{scale}")
    k1_ms = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 50)
    k1_dev = device_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam))
    q = _collision_confs(probs, *traj).reshape(-1, 7).contiguous()
    ops = structure_arrays(probs.robot, torch.float32, dev)
    c, J = arm_fk_spheres_cuda(*ops, q)
    c_ref, J_ref = fk_spheres_torch(*structure_arrays(probs.robot, torch.float64, dev),
                                    q.double())
    err = max(float((c.double() - c_ref).abs().max()), float((J.double() - J_ref).abs().max()))
    log(f"K2 WAM fleet: N={q.shape[0]} f32 max|d|={err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"K2 WAM fleet: max|d| {err} > 1e-5")
    k2_ms = cuda_ms(lambda: arm_fk_spheres_cuda(*ops, q), 20)
    k2_dev = device_ms(lambda: arm_fk_spheres_cuda(*ops, q))
    pts = c.reshape(-1, 3).contiguous()
    check_lookup("WAM fleet packed f32", probs.sdf, pts, True)
    table = _lookup_operands(probs.sdf, True)
    k3_ms = cuda_ms(lambda: sdf_lookup_cuda(pts, *table), 20)
    k3_dev = device_ms(lambda: sdf_lookup_cuda(pts, *table), flush=True)
    log(f"kernel call rates at the WAM fleet's shapes: K1 {k1_ms:.4f} ms, K2 {k2_ms:.4f} ms "
        f"(N={q.shape[0]}), K3 {k3_ms:.4f} ms (N={pts.shape[0]})")
    log(f"kernel device times at the WAM fleet's shapes: K1 {_spread(k1_dev)}, K2 "
        f"{_spread(k2_dev)}, K3 (L2 flushed) {_spread(k3_dev)}")
    b1, b2 = k1_bound(B, b.shape[1], b.shape[2]), k2_bound(q.shape[0], 7, 16)
    b3 = k3_bound(pts, probs.sdf)
    log(f"bounds at the WAM fleet's shapes: K1 {b1[0]:.6f} ms ({b1[1]}), K2 {b2[0]:.6f} ms "
        f"({b2[1]}), K3 {b3[0]:.6f} ms ({b3[1]}; {b3[2]} distinct rows)")


def wam_fleet_sessions(dev, inputs, B=None, seed=0):
    """bench_replan.py's fleet: B (default B_FLEET) WAM sessions, starts and
    goals the base configurations plus 0.05 N(0, 1) (numpy `seed`), float32
    on the main path's field (inputs[1]; inputs[0] the robot), packed once,
    seeded with the straight line. Returns
    (fleet, one_round): one_round(r) pins state k = 1 + r mod 3 at the
    estimate, fuses a noisy state estimate (0.01 N(0, 1), covariance 1e-4)
    at state k + 1 when r is even, moves every goal by 0.02 N(0, 1), runs
    one update and synchronizes; it returns (result, k, the pinned poses)."""
    import torch
    from gpmp2_tpu_torch.planner import (ISAM2BatchSessions, init_traj_straight_line,
                                         make_problem)

    robot, sdf = inputs[0], inputs[1]
    setting = wam_fleet_setting()
    f32, B = torch.float32, B_FLEET if B is None else B
    rng = np.random.default_rng(seed)
    starts = torch.as_tensor(BASE_START + 0.05 * rng.normal(size=(B, 7)), dtype=f32, device=dev)
    goals = torch.as_tensor(BASE_GOAL + 0.05 * rng.normal(size=(B, 7)), dtype=f32, device=dev)
    zeros = torch.zeros_like(starts)
    packed = make_problem(robot, sdf, starts[:1], zeros[:1], goals[:1], zeros[:1], setting).sdf
    if packed.packed is None:
        raise AssertionError("make_problem did not pack the WAM fleet's SDF")
    fleet = ISAM2BatchSessions(robot, packed, setting, B, warm_iter=FLEET_WARM_ITER)
    fleet.init_factor_graph(starts, zeros, goals, zeros)
    fleet.init_values(init_traj_straight_line(fleet.problems.space, starts, goals,
                                              setting.total_step, setting.total_time))
    goal_now = goals

    def one_round(r):
        nonlocal goal_now
        traj = fleet.values()
        k = 1 + r % 3
        pin = traj.pose[:, k]
        fleet.fix_config_and_vel(np.full(B, k), pin, traj.vel[:, k])
        if r % 2 == 0:
            noise = [torch.as_tensor(0.01 * rng.normal(size=(B, 7)), dtype=f32, device=dev)
                     for _ in range(2)]
            fleet.add_state_estimate(np.full(B, k + 1), traj.pose[:, k + 1] + noise[0], 1e-4,
                                     traj.vel[:, k + 1] + noise[1], 1e-4)
        goal_now = goal_now + torch.as_tensor(0.02 * rng.normal(size=(B, 7)), dtype=f32,
                                              device=dev)
        fleet.change_goal_config_and_vel(goal_now, zeros)
        out = fleet.update()
        sync()
        return out, k, pin

    return fleet, one_round


def fleet_rounds(one_round, rounds):
    """Rounds 1 to `rounds` of wam_fleet_sessions' one_round, each timed and
    counted alone. Gates: every final trajectory is finite and, on the card,
    K1, K2 and K3 launch in every round. Returns (the last round's result,
    k, pinned poses, each round's seconds, each round's launches)."""
    import torch

    times, launches = [], []
    for r in range(1, rounds + 1):
        reset_launches()
        t0 = time.perf_counter()
        out, k, pin = one_round(r)
        times.append(time.perf_counter() - t0)
        launches.append(read_launches())
    for name, x in (("pose", out.traj.pose), ("vel", out.traj.vel), ("error", out.error)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"WAM fleet: non-finite final {name}")
    if out.error.is_cuda and min(min(n.values()) for n in launches) == 0:
        raise AssertionError(f"WAM fleet: a kernel was not launched in a timed round: "
                             f"{launches}")
    return out, k, pin, times, launches


def wam_fleet(dev, card, inputs):
    """bench_replan.py's protocol (wam_fleet_sessions): an untimed cold
    update and warm-up round, then FLEET_ROUNDS timed rounds. Gates: K1, K2
    and K3 each launch during the timed rounds and every final trajectory
    is finite; throughput and quality are printed, not gated."""
    import torch

    B = B_FLEET
    fleet, one_round = wam_fleet_sessions(dev, inputs)
    t0 = time.perf_counter()
    cold = fleet.update()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    one_round(0)
    check_fleet_kernels(dev, fleet)
    out, k, pin, times, per_round = fleet_rounds(one_round, FLEET_ROUNDS)
    wall = sum(times)
    launches = {name: sum(n[name] for n in per_round) for name in per_round[0]}
    row = {
        "metric": "wam7_replan_fleet", "batch": B, "rounds": FLEET_ROUNDS,
        "warm_iter": FLEET_WARM_ITER,
        "session_updates_per_s": B * FLEET_ROUNDS / wall,
        "round_ms": 1e3 * wall / FLEET_ROUNDS, "cold_update_s": cold_s,
        "cold_converged_frac": float(cold.converged.float().mean()),
        "cold_gave_up_frac": float(cold.gave_up.float().mean()),
        "converged_frac": float(out.converged.float().mean()),
        "gave_up_frac": float(out.gave_up.float().mean()),
        "mean_iters": float(out.iterations.float().mean()),
        "last_pin_max_abs_dev": float((out.traj.pose[:, k] - pin).abs().max()),
        "launches": launches,
        "launches_per_round": {n: v / FLEET_ROUNDS for n, v in launches.items()},
        "card": card,
    }
    log(json.dumps(row))


def replan_phase(dev, card, inputs):
    """Phase 11: the oracle gates, the fleet card-vs-CPU check, the WAM fleet."""
    replan_oracle_gates(dev)
    replan_card_vs_cpu(dev)
    wam_fleet(dev, card, inputs)


# ---- phase 12: the manual graphs -----------------------------------------------

WAM_GRAPH_STEPS, WAM_GRAPH_CHECK = 10, 100  # wam_factor_graph.py's settings
GRAPH_REPEATS = 3


def wam_graph(robot, sdf, start, goal, recipe=False):
    """wam_factor_graph.py's graph: start and goal priors (sigma 1e-4), a GP
    prior, an obstacle factor and 9 interpolated ones (total_check 100) per
    interval, cost_sigma 0.02, eps 0.2, over 11 states of 2 s. recipe=True:
    the planner's recipe of the main path's setting (an obstacle factor at
    every state, the planner's taus), its factors added in the planner's
    order, to be held against traj_linearize."""
    import torch
    from gpmp2_tpu_torch.planner import FactorGraph

    N, T = WAM_GRAPH_STEPS, 2.0
    dt, inter = T / N, WAM_GRAPH_CHECK // WAM_GRAPH_STEPS - 1
    Qc, zero = np.eye(7), torch.zeros_like(start)
    g = FactorGraph(robot.space, N + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(N, goal, 1e-4)
    g.add_prior_vel(N, zero, 1e-4)
    if recipe:
        for i in range(N):
            g.add_gp_prior(i, i + 1, dt, Qc)
        for i in range(N + 1):
            g.add_obstacle(i, robot, sdf, 0.02, 0.2)
        for i in range(N):
            for j in range(1, inter + 1):
                g.add_obstacle_gp(i, i + 1, robot, sdf, 0.02, 0.2, Qc, dt, j * (dt / (inter + 1)))
        return g
    for i in range(1, N + 1):
        g.add_gp_prior(i - 1, i, dt, Qc)
        g.add_obstacle(i, robot, sdf, 0.02, 0.2)
        for j in range(1, inter + 1):
            g.add_obstacle_gp(i - 1, i, robot, sdf, 0.02, 0.2, Qc, dt, j * (T / WAM_GRAPH_CHECK))
    return g


def wam_graph_params():
    from gpmp2_tpu_torch.solver.optimize import OptimizerParams

    return OptimizerParams(method="lm", max_iter=100, rel_thresh=1e-4)


def check_graph_kernels(dev, robot, sdf):
    """K2 and K3 against their plain versions at the WAM graph's group
    shapes: the 10 support and 90 interpolated configurations of the
    example's straight line, their 160 and 1,440 sphere centres, in the
    packed float32 field `sdf` and the raw float64 one; each timed beside
    its bound, and K1 timed at B = 1, n = 11, m = 14 on the graph's normal
    equations."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda, fk_spheres_torch, structure_arrays
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda
    from gpmp2_tpu_torch.planner import init_traj_straight_line, interpolate_traj

    f32, f64 = torch.float32, torch.float64
    start, goal = (torch.as_tensor(x, dtype=f32, device=dev) for x in (BASE_START, BASE_GOAL))
    line = init_traj_straight_line(robot.space, start, goal, WAM_GRAPH_STEPS, 2.0)
    dense = interpolate_traj(robot.space, line, np.eye(7), 0.2, 9).pose[:-1].reshape(10, 10, 7)
    S, d = 16, 7
    sdf64 = dataclasses.replace(sdf, packed=None).to(dtype=f64)
    for name, q in (("support", line.pose[1:]), ("interpolated", dense[:, 1:].reshape(-1, 7))):
        q = q.contiguous()
        N = q.shape[0]
        for dtype, tol in ((f32, 1e-5), (f64, 1e-12)):
            c, J = arm_fk_spheres_cuda(*structure_arrays(robot, dtype, dev), q.to(dtype))
            c_ref, J_ref = fk_spheres_torch(*structure_arrays(robot, f64, dev), q.double())
            err = max(float((c.double() - c_ref).abs().max()),
                      float((J.double() - J_ref).abs().max()))
            log(f"K2 WAM graph {name}: N={N} {dtype} max|d|={err:.3e}")
            if not err <= tol:
                raise AssertionError(f"K2 WAM graph {name} N={N} {dtype}: max|d| {err} > {tol}")
        pts = c_ref.reshape(-1, 3)
        check_lookup(f"WAM graph {name} packed f32", sdf, pts.float().contiguous(), True)
        check_lookup(f"WAM graph {name} raw f64", sdf64, pts.contiguous(), False)
        ops = structure_arrays(robot, f32, dev)
        q32 = q.float()
        p32 = pts.float().contiguous()
        table = _lookup_operands(sdf, True)
        k2_ms = cuda_ms(lambda: arm_fk_spheres_cuda(*ops, q32), 50)
        k3_ms = cuda_ms(lambda: sdf_lookup_cuda(p32, *table), 50)
        k2_dev = device_ms(lambda: arm_fk_spheres_cuda(*ops, q32))
        k3_dev = device_ms(lambda: sdf_lookup_cuda(p32, *table), flush=True)
        b2, b3 = k2_bound(N, d, S), k3_bound(p32, sdf)
        log(f"WAM graph {name}: K2 at N={N} device time {_spread(k2_dev)}, call rate "
            f"{k2_ms:.4f} ms (bound {b2[0]:.6f} ms, {b2[1]}), K3 at {p32.shape[0]} queries "
            f"device time (L2 flushed) {_spread(k3_dev)}, call rate {k3_ms:.4f} ms (bound "
            f"{b3[0]:.6f} ms, {b3[1]}; {b3[2]} distinct rows)")
    del sdf64
    # K1 on the graph's own normal equations at the example's start
    g = wam_graph(robot, sdf, start, goal)
    D, U, b, _ = (t[None].contiguous() for t in g.linearize(line))
    lam = torch.full((1,), 100.0, device=dev)
    k1_call = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 100)
    k1_dev = device_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam))
    b1 = k1_bound(1, 11, 14)
    log(f"WAM graph: K1 at B=1 n=11 m=14 device time {_spread(k1_dev)}, call rate "
        f"{k1_call:.4f} ms (bound {b1[0]:.6f} ms, {b1[1]})")


def graph_vs_planner(dev, inputs):
    """The WAM graph of the planner's recipe in float64 on the card against
    the port's planner on the same problem (make_problem, B = 1, the raw
    field): linearize at the straight line against traj_linearize's torch
    code (the assembly kernel's route off), err within rtol 1e-12 and
    H_diag, H_off, b within atol 1e-9, and the assembly kernel's
    linearize against that torch code, each output within 1e-12 of its
    largest entry (on the straight line the GP residual cancels to
    rounding, so a block's own norm is no scale); FactorGraph.optimize and
    plan_batch (optimize_batch over traj_linearize) with the same LM
    parameters end within rel 1e-9 of each other, with equal iterations.
    Then the example's graph in float64, card against CPU: final error
    within rel 1e-6, iterations equal."""
    import torch
    from gpmp2_tpu_torch.planner import (Trajectory, init_traj_straight_line, make_problem,
                                         plan_batch, traj_linearize)
    from gpmp2_tpu_torch.robots import generate_arm

    f64 = torch.float64
    _, sdf, setting, _, _, _ = inputs
    params = wam_graph_params()
    out = []
    for k, where in enumerate((dev, torch.device("cpu"))):
        robot = generate_arm("WAMArm", dtype=f64, device=where)
        field = sdf.to(dtype=f64, device=where)
        s, e = (torch.as_tensor(x, dtype=f64, device=where) for x in (BASE_START, BASE_GOAL))
        line = init_traj_straight_line(robot.space, s, e, WAM_GRAPH_STEPS, 2.0)
        if k == 0:
            g = wam_graph(robot, field, s, e, recipe=True)
            z = torch.zeros_like(s)[None]
            probs = make_problem(robot, field, s[None], z, e[None], z, setting, sdf_pack=False)
            batched = Trajectory(line.pose[None], line.vel[None])
            from gpmp2_tpu_torch.ops import assemble
            route = assemble.route
            assemble.route = lambda *args: False
            try:
                ref = traj_linearize(probs, batched)
            finally:
                assemble.route = route
            kernel = traj_linearize(probs, batched)
            scaled = {part: float((a - r).abs().max() / r.abs().max())
                      for part, a, r in zip(("H_diag", "H_off", "b", "err"), kernel, ref)}
            log(f"WAM graph: traj_linearize through the assembly kernel against its torch "
                f"code (f64, card): max|d| / max|ref| {scaled}")
            if not max(scaled.values()) <= 1e-12:
                raise AssertionError(f"WAM graph: assembly kernel against its torch code "
                                     f"{scaled}")
            got = g.linearize(line)
            rel = abs(float(got[3]) - float(ref[3][0])) / float(ref[3][0])
            worst = {part: float((a - r[0]).abs().max())
                     for part, a, r in zip(("H_diag", "H_off", "b"), got, ref)}
            log(f"WAM graph vs planner (f64, card): err {float(got[3]):.6e} rel diff {rel:.2e}, "
                f"max|d| {worst}")
            if not (rel <= 1e-12 and max(worst.values()) <= 1e-9):
                raise AssertionError(f"WAM graph vs planner: err rel {rel}, max|d| {worst}")
            res, res_p = g.optimize(line, params), plan_batch(probs, batched, params)
            rel = abs(float(res.error) - float(res_p.error[0])) / float(res_p.error[0])
            log(f"WAM graph optimize vs plan_batch (f64, card): final {float(res.error):.6f} / "
                f"{float(res_p.error[0]):.6f} (rel {rel:.2e}), iterations "
                f"{int(res.iterations)} / {int(res_p.iterations[0])}")
            if not (rel <= 1e-9 and int(res.iterations) == int(res_p.iterations[0])):
                raise AssertionError("WAM graph optimize and plan_batch disagree")
        out.append(wam_graph(robot, field, s, e).optimize(line, params))
        del field
    card, cpu = out
    rel = abs(float(card.error) - float(cpu.error)) / float(cpu.error)
    log(f"WAM graph card vs CPU (f64): final error {float(card.error):.6f} / "
        f"{float(cpu.error):.6f} (rel {rel:.2e}), iterations {int(card.iterations)} / "
        f"{int(cpu.iterations)}")
    if not (rel <= 1e-6 and int(card.iterations) == int(cpu.iterations)):
        raise AssertionError("WAM graph: card and CPU disagree")


def wam_graph_row(dev, card, inputs, packed):
    """The example's WAM graph in float32 on the main path's field, packed:
    gates are convergence and a finite trajectory, and K1, K2 and K3 each
    launching in the timed optimize; the warm optimize's time (best of
    GRAPH_REPEATS), attempts and launches, the eps = 0 collision cost, and
    the same for plan_batch at B = 1 on the planner's recipe of the same
    problem, printed on one JSON line."""
    import torch
    from gpmp2_tpu_torch.planner import (Trajectory, collision_cost, init_traj_straight_line,
                                         make_problem, plan_batch)

    robot, _, setting, _, _, _ = inputs
    s, e = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (BASE_START, BASE_GOAL))
    z = torch.zeros_like(s)[None]
    probs = make_problem(robot, packed, s[None], z, e[None], z, setting)
    line = init_traj_straight_line(robot.space, s, e, WAM_GRAPH_STEPS, 2.0)
    g = wam_graph(robot, probs.sdf, s, e)
    params = wam_graph_params()

    def timed(solve):
        solve()  # warm-up
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(GRAPH_REPEATS):
            reset_launches()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
            launches = read_launches()
        return res, best * 1e3, launches

    res, ms, launches = timed(lambda: g.optimize(line, params))
    for name, x in (("pose", res.traj.pose), ("vel", res.traj.vel), ("error", res.error)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"WAM graph f32: non-finite final {name}")
    if not bool(res.converged) or bool(res.gave_up):
        raise AssertionError(f"WAM graph f32 did not converge: {res.iterations} iterations")
    if min(launches[k] for k in ("btsolve", "fk_arm", "sdf_lookup")) == 0:
        raise AssertionError(f"WAM graph f32: a kernel was not launched: {launches}")
    batched = Trajectory(line.pose[None], line.vel[None])
    res_p, ms_p, launches_p = timed(lambda: plan_batch(probs, batched, params))
    row = {
        "metric": "wam7_factor_graph", "dtype": "float32", "states": WAM_GRAPH_STEPS + 1,
        "obstacle_factors": WAM_GRAPH_STEPS, "interpolated_factors": 90,
        "optimize_ms": ms, "attempts": launches["btsolve"],
        "iterations": int(res.iterations), "converged": bool(res.converged),
        "final_error": float(res.error),
        "collision_cost_eps0": float(collision_cost(probs, res.traj.pose[None])[0]),
        "launches_per_optimize": launches,
        "plan_batch_b1_ms": ms_p, "plan_batch_attempts": launches_p["btsolve"],
        "plan_batch_iterations": int(res_p.iterations[0]),
        "plan_batch_final_error": float(res_p.error[0]),
        "plan_batch_launches": launches_p, "card": card,
    }
    log(json.dumps(row))


def mobile_graph(dev, dtype):
    """mobile_arm2_factor_graph.py's graph (SimpleTwoLinksArm on SE(2) x R^2,
    20 steps, priors, Lie GP priors, an obstacle factor and vehicle
    dynamics at every state) on a 120^2 planar field of one disc beside
    its path (radius 0.3 at (0, 0.8), in range of the arm's tip; the grid
    offset so that no path point lies on a grid line), and its straight
    line."""
    import torch
    from gpmp2_tpu_torch.planner import FactorGraph, init_traj_straight_line
    from gpmp2_tpu_torch.robots import generate_mobile_arm
    from gpmp2_tpu_torch.utils import convert

    n, cell, origin = 120, 0.05, np.array([-3.013, -3.021])
    X, Y = np.meshgrid(origin[0] + cell * np.arange(n), origin[1] + cell * np.arange(n))
    sdf = convert.planar_sdf_from_numpy(origin, cell, np.sqrt(X**2 + (Y - 0.8) ** 2) - 0.3,
                                        dtype=dtype, device=dev)
    marm = generate_mobile_arm("SimpleTwoLinksArm", dtype=dtype, device=dev)
    N, T = 20, 5.0
    start = torch.tensor([-1.0, 0.0, np.pi / 2, 0.0, 0.0], dtype=dtype, device=dev)
    goal = torch.tensor([1.0, 0.0, np.pi / 2, 0.0, 0.0], dtype=dtype, device=dev)
    zero = torch.zeros_like(start)
    g = FactorGraph(marm.space, N + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(N, goal, 1e-4)
    g.add_prior_vel(N, zero, 1e-4)
    for i in range(N + 1):
        g.add_obstacle(i, marm, sdf, 0.1, 0.1)
        g.add_vehicle_dynamics(i, 0.001)
        if i > 0:
            g.add_gp_prior(i - 1, i, T / N, np.eye(5))
    return g, init_traj_straight_line(marm.space, start, goal, N, T)


def mobile_graph_card_vs_cpu(dev):
    """The mobile graph in float64 under GN, card against CPU: final error
    within rel 1e-6, iterations equal; K1 and K3 launch on the card."""
    import torch
    from gpmp2_tpu_torch.solver.optimize import OptimizerParams

    params = OptimizerParams(method="gaussnewton", max_iter=100, rel_thresh=1e-5)
    out = []
    for where in (dev, torch.device("cpu")):
        g, line = mobile_graph(where, torch.float64)
        reset_launches()
        out.append((float(g.error(line)), g.optimize(line, params), read_launches()))
    (e0, card, launches), (e0_cpu, cpu, _) = out
    rel = abs(float(card.error) - float(cpu.error)) / float(cpu.error)
    log(f"mobile graph card vs CPU (f64, GN): initial error {e0:.6e} / {e0_cpu:.6e}, final "
        f"{float(card.error):.6f} / {float(cpu.error):.6f} (rel {rel:.2e}), iterations "
        f"{int(card.iterations)} / {int(cpu.iterations)}, card launches {launches}")
    if not (rel <= 1e-6 and int(card.iterations) == int(cpu.iterations)):
        raise AssertionError("mobile graph: card and CPU disagree")
    if launches["btsolve"] == 0 or launches["sdf_lookup"] == 0:
        raise AssertionError(f"mobile graph: K1 or K3 was not launched: {launches}")


def multigraph_card_vs_cpu(dev):
    """multi_graph_point_robot.py's graph (MultiObstacleDataset, the point
    robot of radius 1.5, 4 chains of 20 steps drawn on the CPU from a
    generator seeded 42, inter-chain edges with probability 0.5, seed 1)
    in float64 on the card and on the CPU: multigraph_error before and
    after within rel 1e-6, equal accepted steps, the same Dijkstra path;
    K3 launches on the card."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.geometry.statespace import VectorSpace
    from gpmp2_tpu_torch.kinematics import PointRobotFK, make_robot_model
    from gpmp2_tpu_torch.planner import (build_planner_graph, edge_costs,
                                         make_multigraph_problem, multigraph_error,
                                         optimize_multigraph, sample_initializations,
                                         shortest_path)

    f64, cpu = torch.float64, torch.device("cpu")
    n_steps, total_time = 20, 10.0
    dt = total_time / n_steps
    start = torch.tensor([0.0, 0.0], dtype=f64)
    goal = torch.tensor([17.0, 14.0], dtype=f64)
    chains = sample_initializations(VectorSpace(2), start, goal, n_steps, total_time, np.eye(2),
                                    4, torch.Generator().manual_seed(42))
    pose0, vel0, edges = build_planner_graph(chains, (goal / n_steps) / dt, 0.5, 1)
    ds = generate_2d_dataset("MultiObstacleDataset")
    out = []
    for where in (dev, cpu):
        sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=f64, device=where)
        robot = make_robot_model(PointRobotFK(), [(0, 1.5, (0.0, 0.0, 0.0))], dtype=f64,
                                 device=where)
        z = torch.zeros(2, dtype=f64, device=where)
        prob = make_multigraph_problem(robot, sdf, edges, start.to(where), z, goal.to(where), z,
                                       dt=dt, Qc=np.eye(2), cost_sigma=0.5, epsilon=4.0,
                                       obs_check_inter=1, dtype=f64)
        P, V = (torch.as_tensor(x, dtype=f64, device=where) for x in (pose0, vel0))
        reset_launches()
        e0 = float(multigraph_error(prob, P, V))
        pose, vel, err, iters, done = optimize_multigraph(prob, P, V)
        path = shortest_path(prob.edges, *edge_costs(prob, pose, vel))
        out.append((e0, float(err), int(iters), bool(done), path, read_launches()))
    card, plain = out
    rel0 = abs(card[0] - plain[0]) / plain[0]
    rel1 = abs(card[1] - plain[1]) / plain[1]
    log(f"multigraph card vs CPU (f64, {pose0.shape[0]} nodes, {edges.shape[0]} edges): initial "
        f"error {card[0]:.6e} (rel {rel0:.2e}), final {card[1]:.6f} / {plain[1]:.6f} (rel "
        f"{rel1:.2e}), steps {card[2]} / {plain[2]}, converged {card[3]} / {plain[3]}, path "
        f"{card[4]}, card launches {card[5]}")
    if not (rel0 <= 1e-6 and rel1 <= 1e-6 and card[2] == plain[2] and card[4] == plain[4]):
        raise AssertionError("multigraph: card and CPU disagree")
    if card[5]["sdf_lookup"] == 0:
        raise AssertionError(f"multigraph: K3 was not launched: {card[5]}")


def graph_phase(dev, card, inputs):
    """Phase 12: K2 and K3 at the WAM graph's shapes, the WAM graph against
    the planner and card against CPU, the float32 WAM graph row, the mobile
    graph and the multigraph card against CPU."""
    from gpmp2_tpu_torch.obstacle.sdf import pack_sdf

    packed = pack_sdf(inputs[1])
    check_graph_kernels(dev, inputs[0], packed)
    graph_vs_planner(dev, inputs)
    wam_graph_row(dev, card, inputs, packed)
    del packed
    mobile_graph_card_vs_cpu(dev)
    multigraph_card_vs_cpu(dev)


# ---- phase 13: SE(3) states and the remaining examples ---------------------------

POSE3_N, POSE3_DT = 6, 0.4  # tests/test_gp.py::TestSE3Chain's chain
POSE3_START = [0.3, -0.2, 0.5, 1.0, 2.0, -1.0]
POSE3_GOAL = [-0.4, 0.3, 1.2, 3.0, -1.0, 0.5]
B_M12 = 2048
# the thirteen examples_torch/ scripts of this phase, in order; the five
# arm scripts run K2, every one has an obstacle factor (K3) and solves (K1)
EXAMPLES = ["arm3_factor_graph", "arm3_joint_limit", "arm3_planner",
            "mobile_2arms_factor_graph", "mobile_arm_planning", "mobile_base", "point_robot_2d",
            "point_robot_3d", "point_robot_3d_rh", "receding_horizon", "wam_replanner",
            "mobile_arm_replanner", "wam_workspace_constraints"]
ARM_EXAMPLES = {"arm3_factor_graph", "arm3_joint_limit", "arm3_planner", "wam_replanner",
                "wam_workspace_constraints"}
# the receding-horizon loops: the card reaches (or settles) exactly when the CPU does
LOOP_OUTCOMES = {"receding_horizon": ("reached",), "point_robot_3d_rh": ("reached", "settled")}


def pose3_chain(where):
    """The Pose3 chain as a FactorGraph on SE3Space in float64: 6 states,
    dt 0.4, Qc = I6, start and goal priors and zero end velocities at sigma
    1e-2, a GP prior per interval; with its straight-line init."""
    import torch
    from gpmp2_tpu_torch import FactorGraph, SE3Space
    from gpmp2_tpu_torch.planner import init_traj_straight_line

    f64 = torch.float64
    space = SE3Space()
    start, goal = (space.retract(space.identity(f64, where), torch.tensor(x, dtype=f64,
                                                                          device=where))
                   for x in (POSE3_START, POSE3_GOAL))
    zero = torch.zeros(6, dtype=f64, device=where)
    g = FactorGraph(space, POSE3_N)
    g.add_prior_pose(0, start, 1e-2)
    g.add_prior_vel(0, zero, 1e-2)
    g.add_prior_pose(POSE3_N - 1, goal, 1e-2)
    g.add_prior_vel(POSE3_N - 1, zero, 1e-2)
    for i in range(POSE3_N - 1):
        g.add_gp_prior(i, i + 1, POSE3_DT, np.eye(6))
    return g, init_traj_straight_line(space, start, goal, POSE3_N - 1, 2.0)


def check_btsolve_m12(dev):
    """K1 at the Pose3 chain's block size m = 12: on the chain's own normal
    equations (B = 1, n = 6, float64, lambda = 100, LM's first) and on
    random_system at B = 2048, n = 6 in float32 and float64, against the
    plain version in float64 on the same rounded inputs (check_btsolve_m36's
    tolerances); the random systems timed with their bounds."""
    import torch
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda, block_tridiag_solve_torch
    from gpmp2_tpu_torch.testing import random_system

    g, line = pose3_chain(dev)
    D, U, b, _ = (t[None].contiguous() for t in g.linearize(line))
    cases = [("Pose3 chain f64", None, (D, U, b, torch.full((1,), 100.0, dtype=D.dtype,
                                                           device=dev)), 1e-10, None)]
    for key, dtype, tol, peak in (("f32", torch.float32, 1e-4, F32_FLOPS),
                                  ("f64", torch.float64, 1e-10, F64_FLOPS)):
        ops = tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in random_system(B_M12, POSE3_N, 12, seed=12, conditioned=True))
        cases.append((f"B={B_M12} {key}", key, ops, tol, peak))
    out = {}
    for name, key, (D, U, b, lam), tol, peak in cases:
        x = block_tridiag_solve_cuda(D, U, b, True, lam)
        torch.cuda.synchronize()
        x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(), True, lam.double())
        err, scale = float((x.double() - x_ref).abs().max()), float(x_ref.abs().max())
        log(f"K1 m=12 {name}: max|dx|={err:.3e} max|x|={scale:.3e}")
        if not err <= tol * scale:
            raise AssertionError(f"K1 m=12 {name}: max|dx| {err} > {tol} * {scale}")
        if key is None:  # the chain's system is checked, not timed
            continue
        ms = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 20)
        bound_ms, bound_by = k1_bound(B_M12, POSE3_N, 12, D.element_size(), peak)
        log(f"K1 time at B={B_M12} n={POSE3_N} m=12 {key}: kernel {ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by})")
        out[f"ms_m12_{key}"] = ms
        out[f"bound_ms_m12_{key}"] = bound_ms
    return out


def pose3_chain_card_vs_cpu(dev):
    """The Pose3 chain under LM (max_iter 50) in float64, card against CPU:
    final errors within rel 1e-9, equal iterations and converged flags; K1
    must launch on the card. Returns the card's K1 launches."""
    import torch
    from gpmp2_tpu_torch.solver.optimize import OptimizerParams

    params = OptimizerParams(method="lm", max_iter=50)
    out = []
    for where in (dev, torch.device("cpu")):
        g, line = pose3_chain(where)
        reset_launches()
        res = g.optimize(line, params)
        out.append((float(g.error(line)), res, read_launches()))
    (e0, card, launches), (e0_cpu, cpu, _) = out
    rel = abs(float(card.error) - float(cpu.error)) / float(cpu.error)
    log(f"Pose3 chain card vs CPU (f64, LM): initial error {e0:.6f} / {e0_cpu:.6f}, final "
        f"{float(card.error):.10f} / {float(cpu.error):.10f} (rel {rel:.2e}), iterations "
        f"{int(card.iterations)} / {int(cpu.iterations)}, converged {bool(card.converged)} / "
        f"{bool(cpu.converged)}, card launches {launches}")
    if not (rel <= 1e-9 and int(card.iterations) == int(cpu.iterations)
            and bool(card.converged) == bool(cpu.converged)):
        raise AssertionError("Pose3 chain: card and CPU disagree")
    if launches["btsolve"] == 0:
        raise AssertionError(f"Pose3 chain: K1 was not launched: {launches}")
    return launches["btsolve"]


def run_example(name, cpu):
    """examples_torch/<name>.py run in this process as `__main__`, on the
    card or with --cpu, its output captured: (its `result` JSON, wall ms).
    Raises with the script's output when it fails."""
    import contextlib
    import gc
    import io
    import runpy

    import torch

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch",
                        name + ".py")
    argv, sys.argv = sys.argv, [path] + (["--cpu"] if cpu else [])
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
        if not cpu:
            torch.cuda.synchronize()
    except (Exception, SystemExit) as e:
        log(buf.getvalue()[-3000:])
        raise AssertionError(f"{name} ({'CPU' if cpu else 'card'}) failed: {e!r}") from e
    finally:
        sys.argv = argv
    ms = (time.perf_counter() - t0) * 1e3
    gc.collect()
    torch.cuda.empty_cache()
    last = buf.getvalue().strip().splitlines()[-1]
    if not last.startswith("result "):
        raise AssertionError(f"{name}: no result line, last line {last!r}")
    return json.loads(last[len("result "):]), ms


def examples_card_vs_cpu():
    """Each of the thirteen scripts on the card (launches counted) and on
    the CPU: it runs to its end on both, with its own asserts; K1 and K3
    launch in every one and K2 in the arm scripts; the card's final error
    is finite and within rel 1e-3 of the CPU's; where the CPU converged the
    card converged; the loops reach their goal (or settle) on the card
    exactly when on the CPU. One JSON line per script."""
    import math

    for name in EXAMPLES:
        reset_launches()
        card, card_ms = run_example(name, cpu=False)
        launches = read_launches()
        cpu, cpu_ms = run_example(name, cpu=True)
        rel = abs(card["error"] - cpu["error"]) / max(abs(cpu["error"]), 1e-30)
        log(json.dumps({"example": name, "card_ms": round(card_ms, 1),
                        "cpu_ms": round(cpu_ms, 1),
                        "iterations": [card["iterations"], cpu["iterations"]],
                        "final_error": [card["error"], cpu["error"]], "rel": rel,
                        "converged": [card["converged"], cpu["converged"]],
                        "launches": launches}))
        fails = []
        if not math.isfinite(card["error"]):
            fails.append("final error not finite")
        if launches["btsolve"] == 0 or launches["sdf_lookup"] == 0:
            fails.append("K1 or K3 was not launched")
        if name in ARM_EXAMPLES and launches["fk_arm"] == 0:
            fails.append("K2 was not launched")
        if cpu["converged"] and not card["converged"]:
            fails.append("converged on the CPU, not on the card")
        if not rel <= 1e-3:
            fails.append(f"final errors differ by rel {rel:.2e}")
        for key in LOOP_OUTCOMES.get(name, ()):
            if card[key] != cpu[key]:
                fails.append(f"{key}: card {card[key]}, CPU {cpu[key]}")
        if fails:
            raise AssertionError(f"{name}: " + "; ".join(fails))


def se3_examples_phase(dev):
    """Phase 13: K1 at m = 12, the Pose3 chain card against CPU, and the
    thirteen examples card against CPU. Returns K1's m = 12 numbers for the
    kernels' line."""
    k1_12 = check_btsolve_m12(dev)
    k1_12["launches_pose3_chain"] = pose3_chain_card_vs_cpu(dev)
    examples_card_vs_cpu()
    return k1_12


# ---- phase 14: long horizon, the mesh and the sharded solves, batch_fleet ------

# bench_longhorizon.py's protocol: B random SPD systems of m = 14 blocks
LH_B, LH_M, LH_NS = 256, 14, (65, 129, 257, 1025)
# the long-horizon planner of tests/test_sharding.py: 257 states, 8 parts
TS_STEPS, TS_BATCH, TS_PARTS = 256, 8, 8
FLEET_EXAMPLE_BATCH = 256  # examples_torch/batch_fleet.py's FLEET_BATCH default
FLEET_EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch",
                             "batch_fleet.py")


def lh_system(rng, n, dev, B=None):
    """bench_longhorizon.py's make_system for B (default LH_B) lanes: D_i =
    A A^T / m + (m + 2) I, U_i = 0.3 N(0, 1), b = N(0, 1), float32, drawn
    from `rng` in its order."""
    import torch

    B, m = LH_B if B is None else B, LH_M
    A = rng.normal(size=(B, n, m, m)).astype(np.float32)
    D = A @ np.swapaxes(A, -1, -2) / m + (m + 2) * np.eye(m, dtype=np.float32)
    U = 0.3 * rng.normal(size=(B, n - 1, m, m)).astype(np.float32)
    b = rng.normal(size=(B, n, m)).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (D, U, b)]


def lh_residual(D, U, b, x):
    """The worst lane's |H x - b| / |b|, in float64."""
    from gpmp2_tpu_torch.solver.optimize import _apply_H

    D, U, b, x = (t.double() for t in (D, U, b, x))
    r = (_apply_H(D, U, x) - b).flatten(1).norm(dim=1)
    return float((r / b.flatten(1).norm(dim=1)).max())


def timed_calls(fn, repeats=3):
    """A warm-up call of fn, then `repeats` timed calls, each ended by a
    sync: (the last call's result, each timed call's host ms)."""
    fn()
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def best_of_3(fn):
    """fn's result and its best host time of 3 after a warm-up, in ms, each
    ended by a synchronize."""
    out, times = timed_calls(fn)
    return out, min(times)


def _check_k1(name, D, U, b, jacobi, lam, tol):
    """K1 on (D, U, b, lam) against its plain version in float64 on the
    same rounded inputs: max|dx| within tol * max|x|."""
    import torch
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda, block_tridiag_solve_torch

    x = block_tridiag_solve_cuda(D, U, b, jacobi, lam)
    torch.cuda.synchronize()
    x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(), jacobi,
                                      None if lam is None else lam.double())
    err, scale = float((x.double() - x_ref).abs().max()), float(x_ref.abs().max())
    B, n, m = b.shape
    log(f"K1 {name}: B={B} n={n} m={m} {b.dtype} max|dx|={err:.3e} max|x|={scale:.3e}")
    if not err <= tol * scale:
        raise AssertionError(f"K1 {name}: max|dx| {err} > {tol} * {scale}")


def separator_system(D, U, b, n_parts):
    """The (P-1)-block separator system that block_tridiag_solve_partitioned
    (and the ts-sharded solve on one rank) hands K1 for (D, U, b): Jacobi
    scaling, the partition, the segment stage, the Schur reduction."""
    from gpmp2_tpu_torch.solver.partitioned import (_jacobi_scale, _partition, _schur_reduce,
                                                    _segment_stage)

    D, U, b, _ = _jacobi_scale(D, U, b)
    D_seg, U_seg, b_seg, a, c, D_sep, b_sep, *_ = _partition(D, U, b, n_parts)
    return _schur_reduce(_segment_stage(D_seg, U_seg, b_seg), a, c, D_sep, b_sep)


def check_phase14_kernels(dev, fleet):
    """K1, K2 and K3 against their plain versions at the shapes phase 14's
    paths give them, before any of its timings (phase 3's and phase 11's
    tolerances: K1 float32 within 1e-4 of max|x| of the plain version in
    float64 on the rounded inputs, float64 within 1e-10; K2 1e-5;
    check_lookup):
      - K1 on the long-horizon systems at n = 1025 (B = 256, m = 14) in
        float32 and float64, and on the separator system the partitioned
        solve builds from them (P = 16);
      - K1 on the separator system of the ts planner's first damped solve
        (lambda 100, TS_PARTS parts, float64);
      - K1 on batch_fleet's normal equations at its straight-line start
        (lambda 100), K2 on its collision configurations, K3 on their
        sphere centres in its 48^3 ball field;
      - K3 on the ts planner's centres in its 96^2 planar float64 field."""
    import torch
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda, fk_spheres_torch, structure_arrays
    from gpmp2_tpu_torch.planner import traj_linearize
    from gpmp2_tpu_torch.planner.problem import _collision_confs, _spheres_and_jac
    from gpmp2_tpu_torch.solver.optimize import _damped

    n = LH_NS[-1]
    D, U, b = lh_system(np.random.default_rng(2), n, dev)
    _check_k1(f"long horizon n={n}", D, U, b, True, None, 1e-4)
    _check_k1(f"long horizon n={n}", D.double(), U.double(), b.double(), True, None, 1e-10)
    P = max(2, min(64, n // 64))
    _check_k1(f"long horizon n={n} separator system (P={P})", *separator_system(D, U, b, P),
              False, None, 1e-4)

    probs, init, params = ts_planner_inputs(dev)
    D, U, b, _ = traj_linearize(probs, init)
    lam = torch.full((TS_BATCH,), params.lambda_init, dtype=b.dtype, device=dev)
    _check_k1(f"ts planner separator system (P={TS_PARTS}, lambda {params.lambda_init})",
              *separator_system(_damped(D, lam), U, b, TS_PARTS), False, None, 1e-10)
    confs = _collision_confs(probs, *init)
    centres, _ = _spheres_and_jac(probs.robot, confs)
    check_lookup("ts planner 96^2 planar f64", probs.sdf,
                 centres.reshape(-1, centres.shape[-1]).contiguous(), probs.sdf.packed is not None)

    probs, init, params = fleet["fleet_problems"](FLEET_EXAMPLE_BATCH, dev)
    D, U, b, _ = traj_linearize(probs, init)
    lam = torch.full((b.shape[0],), params.lambda_init, dtype=b.dtype, device=dev)
    _check_k1(f"batch_fleet lambda {params.lambda_init}", D, U, b, True, lam, 1e-4)
    q = _collision_confs(probs, *init).reshape(-1, 7).contiguous()
    c, J = arm_fk_spheres_cuda(*structure_arrays(probs.robot, torch.float32, dev), q)
    c_ref, J_ref = fk_spheres_torch(*structure_arrays(probs.robot, torch.float64, dev),
                                    q.double())
    err = max(float((c.double() - c_ref).abs().max()), float((J.double() - J_ref).abs().max()))
    log(f"K2 batch_fleet: N={q.shape[0]} f32 max|d|={err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"K2 batch_fleet: max|d| {err} > 1e-5")
    check_lookup("batch_fleet 48^3 ball f32", probs.sdf, c.reshape(-1, 3).contiguous(),
                 probs.sdf.packed is not None)


def lh_rows(dev, card, B=None, seed=0, repeats=3, ns=LH_NS):
    """bench_longhorizon.py's protocol: at each n of `ns`, on B
    (default LH_B) lh_system systems drawn from numpy `seed`, K1 and the
    partitioned solve (P = max(2, min(64, n // 64))) on the same systems,
    `repeats` host-timed solves after a warm-up, the device time between
    two events around a solve (device_ms; on the card only), the worst
    lane's relative residual (below 1e-4). K1 must launch in every solve on
    the card (the partitioned solve's separator system is K1). Yields
    (JSON line, K1 launches over the warm-up and the timed solves)."""
    import torch
    from gpmp2_tpu_torch.ops.btsolve import batched_block_tridiag_solve
    from gpmp2_tpu_torch.solver.partitioned import block_tridiag_solve_partitioned

    rng = np.random.default_rng(seed)
    on_card = dev.type == "cuda"
    for n in ns:
        D, U, b = lh_system(rng, n, dev, B)
        P = max(2, min(64, n // 64))
        solvers = (("K1", lambda: batched_block_tridiag_solve(D, U, b)),
                   (f"partitioned(P={P})",
                    lambda: block_tridiag_solve_partitioned(D, U, b, P)))
        for name, solve in solvers:
            counts = []

            def counted():
                reset_launches()
                x = solve()
                counts.append(read_launches()["btsolve"])
                return x
            x, times = timed_calls(counted, repeats)
            if on_card and min(counts) == 0:
                raise AssertionError(f"long horizon n={n} {name}: K1 was not launched")
            res = lh_residual(D, U, b, x)
            if not (bool(torch.isfinite(x).all()) and res < 1e-4):
                raise AssertionError(f"long horizon n={n} {name}: residual {res}")
            yield {"metric": "long_horizon", "n": n, "m": LH_M, "B": b.shape[0],
                   "solver": name, "ms": min(times), "median_ms": float(np.median(times)),
                   "times_ms": times,
                   "device_ms": device_ms(solve, reps=5)[0] if on_card else None,
                   "rel_residual": res, "k1_launches_per_solve": counts[-1],
                   "card": card}, sum(counts)


def long_horizon(dev, card):
    """lh_rows on the card, one JSON line per (n, solver); then both solvers
    in float64 at n = 257 must agree within rel 1e-10. Writes no file."""
    from gpmp2_tpu_torch.ops.btsolve import batched_block_tridiag_solve
    from gpmp2_tpu_torch.solver.partitioned import block_tridiag_solve_partitioned

    k1_launches = {}
    for row, launches in lh_rows(dev, card):
        k1_launches[f"n={row['n']} {row['solver']}"] = launches
        log(json.dumps(row))
    rng = np.random.default_rng(1)
    D, U, b = (t.double() for t in lh_system(rng, 257, dev))
    x_k1 = batched_block_tridiag_solve(D, U, b)
    x_p = block_tridiag_solve_partitioned(D, U, b, 4)
    rel = float((x_p - x_k1).abs().max() / x_k1.abs().max())
    log(f"long horizon f64 n=257: partitioned(P=4) against K1 max|dx|/max|x| {rel:.3e}")
    if not rel <= 1e-10:
        raise AssertionError(f"long horizon f64: partitioned and K1 differ by rel {rel}")
    return k1_launches


def ts_planner_inputs(dev):
    """tests/test_sharding.py's long-horizon planner in float64 on `dev`:
    the point robot in its 96^2 disc field, TS_STEPS intervals, TS_BATCH
    problems (numpy seed 3), LM: (problems, straight-line init, parameters)."""
    import torch
    from gpmp2_tpu_torch.kinematics import PointRobotFK, make_robot_model
    from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF
    from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                         make_problem)
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting

    f64, B = torch.float64, TS_BATCH
    ys = -1.5 + 3.0 / 95 * np.arange(96)
    X, Y = np.meshgrid(ys, ys)
    sdf = PlanarSDF(torch.tensor([-1.5, -1.5], dtype=f64, device=dev),
                    torch.tensor(3.0 / 95, dtype=f64, device=dev),
                    torch.as_tensor(np.sqrt(X**2 + (Y - 0.12) ** 2) - 0.3, dtype=f64,
                                    device=dev))
    robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))], dtype=f64,
                             device=dev)
    setting = TrajOptimizerSetting(dof=2, total_step=TS_STEPS, total_time=5.0,
                                   obs_check_inter=0, opt_type="lm", max_iter=30,
                                   rel_thresh=1e-4, Qc=np.eye(2))
    rng = np.random.default_rng(3)
    starts = np.stack([np.full(B, -0.8), rng.uniform(-0.5, 0.5, B)], -1)
    goals = np.stack([np.full(B, 0.8), rng.uniform(-0.5, 0.5, B)], -1)
    s, g = (torch.as_tensor(x, dtype=f64, device=dev) for x in (starts, goals))
    z = torch.zeros_like(s)
    probs = make_problem(robot, sdf, s, z, g, z, setting)
    init = init_traj_straight_line(probs.space, s, g, TS_STEPS, 5.0)
    return probs, init, optimizer_params_from_setting(setting)


def sharded_one_card(dev, card):
    """The sharded paths on a one-rank NCCL group (make_mesh opens it): the
    ts-sharded solve of tests/test_partitioned.py's system (n = 127, m = 6,
    P = 8, float64) against K1 unsharded (rel 1e-10), and the long-horizon
    planner with ts_mesh on a (dp = 1, ts = 1) mesh against plan_batch
    without one (final errors rel 1e-8, equal iterations and converged
    flags; K1 must launch: the separator systems). Returns the
    (dp = 1, ts = 1) mesh."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.ops.btsolve import batched_block_tridiag_solve
    from gpmp2_tpu_torch.parallel import make_mesh, shard_problems
    from gpmp2_tpu_torch.planner import plan_batch
    from gpmp2_tpu_torch.solver import block_tridiag_solve_ts_sharded

    ts_mesh = make_mesh(axis_names=("ts",), device=dev)
    mesh = make_mesh(shape=(1, 1), axis_names=("dp", "ts"), device=dev)
    log(f"meshes: {ts_mesh}, {mesh}; backend {torch.distributed.get_backend()}")
    rng = np.random.default_rng(9)
    n, m = 127, 6
    A = rng.normal(size=(n, m, m))
    D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m)
    U = 0.3 * rng.normal(size=(n - 1, m, m))
    b = rng.normal(size=(n, m))
    D, U, b = (torch.as_tensor(x, device=dev) for x in (D, U, b))
    x = block_tridiag_solve_ts_sharded(ts_mesh, D, U, b, 8)
    x_k1 = batched_block_tridiag_solve(D[None], U[None], b[None])[0]
    rel = float((x - x_k1).abs().max() / x_k1.abs().max())
    log(f"ts-sharded solve n={n} m={m} P=8 f64 (one rank) against K1: rel {rel:.3e}")
    if not rel <= 1e-10:
        raise AssertionError(f"ts-sharded solve: rel {rel} against K1")

    probs, init, params = ts_planner_inputs(dev)
    t0 = time.perf_counter()
    plain = plan_batch(probs, init, params)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    ts = plan_batch(*shard_problems(mesh, probs, init),
                    dataclasses.replace(params, ts_mesh=mesh, ts_parts=TS_PARTS))
    torch.cuda.synchronize()
    ts_s = time.perf_counter() - t0
    launches = read_launches()
    rel = float(((ts.error - plain.error).abs() / plain.error.abs()).max())
    row = {"metric": "ts_planner_one_card", "states": TS_STEPS + 1, "batch": TS_BATCH,
           "ts_parts": TS_PARTS, "rel_error": rel,
           "iterations": [ts.iterations.tolist(), plain.iterations.tolist()],
           "converged": [int(ts.converged.sum()), int(plain.converged.sum())],
           "ts_s": ts_s, "plain_s": plain_s, "launches": launches, "card": card}
    log(json.dumps(row))
    if not (rel <= 1e-8 and torch.equal(ts.iterations, plain.iterations)
            and torch.equal(ts.converged, plain.converged)):
        raise AssertionError("ts planner: the sharded solve and plan_batch disagree")
    if launches["btsolve"] == 0:
        raise AssertionError(f"ts planner: K1 was not launched: {launches}")
    return mesh, launches


def batch_fleet_phase(dev, card, mesh, fleet):
    """examples_torch/batch_fleet.py on the card: its plan_fleet on the 'dp'
    dim of `mesh` in this process (K1, K2 and K3 must launch), whose
    fleet_stats must equal the host sums of plan_batch's result on the same
    problems without a mesh (n, converged and gave_up exactly, the mean
    error within rel 1e-6); then the script itself, which spawns one NCCL
    rank per visible card, must end on a result line for the whole fleet."""
    import torch
    from gpmp2_tpu_torch.planner import plan_batch

    B = FLEET_EXAMPLE_BATCH
    reset_launches()
    _, stats, t_first, t_repeat = fleet["plan_fleet"](mesh, B, dev)
    launches = read_launches()
    ref = plan_batch(*fleet["fleet_problems"](B, dev))
    host = {"n": ref.error.numel(), "converged": int(ref.converged.sum()),
            "gave_up": int(ref.gave_up.sum()), "mean_error": float(ref.error.double().mean())}
    rel = abs(stats["mean_error"] - host["mean_error"]) / abs(host["mean_error"])
    log(json.dumps({"metric": "batch_fleet_one_card", "batch": B, "fleet_stats": stats,
                    "host_sums": host, "mean_error_rel": rel, "first_s": t_first,
                    "repeat_ms": t_repeat * 1e3, "launches": launches, "card": card}))
    if not (stats["n"] == host["n"] and stats["converged"] == host["converged"]
            and stats["gave_up"] == host["gave_up"] and rel <= 1e-6):
        raise AssertionError(f"batch_fleet: fleet_stats {stats} against host sums {host}")
    if min(launches.values()) == 0:
        raise AssertionError(f"batch_fleet: a kernel was not launched: {launches}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, FLEET_EXAMPLE], capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        log(out.stdout[-3000:], out.stderr[-3000:])
        raise AssertionError(f"examples_torch/batch_fleet.py exited {out.returncode}")
    last = out.stdout.strip().splitlines()[-1]
    if not last.startswith("result "):
        raise AssertionError(f"batch_fleet.py: no result line, last line {last!r}")
    result = json.loads(last[len("result "):])
    log(json.dumps({"example": "batch_fleet", "wall_s": wall, **result}))
    if not (result["n"] == B and np.isfinite(result["error"])
            and result["ranks"] == torch.cuda.device_count()):
        raise AssertionError(f"batch_fleet.py: result {result}")
    return launches


def parallel_phase(dev, card):
    """Phase 14: the long-horizon protocol, the sharded paths on one card,
    batch_fleet; the process group is destroyed at the end. Returns each
    path's launches."""
    import runpy

    import torch.distributed as dist

    t0 = time.perf_counter()
    fleet = runpy.run_path(FLEET_EXAMPLE, run_name="batch_fleet")
    check_phase14_kernels(dev, fleet)
    log(f"phase 14's kernel checks took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = {"long_horizon": long_horizon(dev, card)}
    log(f"long horizon took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh, launches["ts_planner"] = sharded_one_card(dev, card)
    log(f"the sharded paths took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["batch_fleet"] = batch_fleet_phase(dev, card, mesh, fleet)
    log(f"batch_fleet took {time.perf_counter() - t0:.1f} s")
    dist.destroy_process_group()
    return launches


# ---- phase 15: the opt-in SDF variants -------------------------------------------

COARSE_FACTOR = 8  # screen_sdf's default, the JAX package's
# the main path's options of this phase: (name, GPMP2_TPU_PACK_DTYPE, screen)
VARIANT_PATHS = (("pack_f16", "float16", None), ("screen_boxes", "", "hull"),
                 ("screen_sdf", "", "coarse"))


def _screens(dev, sdf):
    """The main path's field with the hull screen (WAMDeskDataset's boxes)
    and with the coarse screen (factor 8), unpacked."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.datasets import dataset_screen_boxes, generate_3d_dataset
    from gpmp2_tpu_torch.obstacle.sdf import screen_sdf

    boxes = torch.as_tensor(dataset_screen_boxes(generate_3d_dataset("WAMDeskDataset")),
                            dtype=sdf.data.dtype, device=dev)
    raw = dataclasses.replace(sdf, packed=None)
    return {"hull": dataclasses.replace(raw, screen_boxes=boxes),
            "coarse": screen_sdf(raw, COARSE_FACTOR)}


def check_variant_lookups(dev, wam_sdf, wam_pts, eps_total, default_ms):
    """K3's new instantiations against their plain versions (check_lookup):
    float16 and bfloat16 rows and the hull and coarse screens (thresholds
    eps_total per sphere) at the main path's queries, the corner-major
    table at PointRobot2D's and MultiWorld2D's queries (its interleaved and
    its direct route) and on the edges. Each is timed (device_ms, L2
    flushed) beside its own bound and its plain version's time, the
    row-major planar default checked and timed beside the corner-major
    table at both planar shapes with F.grid_sample's device
    time as their yardstick, and the default 3D instantiation again, which
    must stay within 3% of its phase-5 time. Returns the kernels' line's
    `variants` and the default's time."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF, pack_planar_sdf, pack_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import (corner_major_route, screen_bound,
                                                sdf_lookup_cuda, sdf_lookup_torch)

    f32 = torch.float32
    N = wam_pts.shape[0]
    S = eps_total.shape[0]
    thresh = eps_total.contiguous()
    variants = {}

    def timed(name, sdf, pts, kw, bound_args, qpw=0, screened=None):
        operands = _lookup_operands(sdf, True)
        ms = device_ms(lambda: sdf_lookup_cuda(pts, *operands, qpw, **kw), flush=True)
        plain_ms = cuda_ms(lambda: sdf_lookup_torch(pts, *operands, qpw, **kw), 3)
        b = bound_args()
        frac = 0.0 if screened is None else float(screened.float().mean())
        variants[name] = {"ms": ms[0], "plain_ms": plain_ms, "bound_ms": b[0],
                          "bound_by": b[1], "screened_fraction": frac}
        log(f"K3 {name} at N={pts.shape[0]}: device time, L2 flushed, {_spread(ms)}; bound "
            f"{b[0]:.6f} ms ({b[1]}; {b[2]} distinct rows), {100 * b[0] / ms[0]:.1f}% of it"
            f"; screened fraction {frac:.4f}; plain {plain_ms:.4f} ms")

    for name, dtype in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        narrow = pack_sdf(wam_sdf, dtype)
        check_lookup(f"WAM packed {name} f32", narrow, wam_pts, True)
        check_lookup(f"WAM packed {name} f64", narrow.to(dtype=torch.float64),
                     wam_pts.double(), True)
        timed(name, narrow, wam_pts, {}, lambda: k3_bound(wam_pts, narrow, row_bytes=16))
        del narrow

    for name, field in _screens(dev, wam_sdf).items():
        packed = pack_sdf(field)
        check_lookup(f"WAM {name}-screened packed f32", packed, wam_pts, True, thresh=thresh)
        check_lookup(f"WAM {name}-screened raw f64", field.to(dtype=torch.float64),
                     wam_pts.double(), False, thresh=thresh.double())
        kw = _variant(packed, True, thresh)
        screen = {k: v for k, v in kw.items() if k != "corner_major"}
        _, screened = screen_bound(wam_pts, packed.origin, packed.cell_size, **screen)
        if name == "hull":
            once, flops = packed.screen_boxes.numel() * 4 + S * 4, 22 * packed.screen_boxes.shape[0]
        else:
            once, flops = packed.coarse.numel() * 4 + S * 4, 15
        timed(name, packed, wam_pts, kw,
              lambda: k3_bound(wam_pts, packed, read=~screened, once_bytes=once,
                               screen_flops=flops), screened=screened)
        del packed
    log("K3 screens as one thread a query, before the persistent design (recorded, not "
        "measured in this run): " + ", ".join(
            f"{name} {lo}-{hi} ms" for name, (lo, hi) in RECORDED_SCREEN_MS.items()))

    wam_packed = pack_sdf(wam_sdf)
    again = device_ms(lambda: sdf_lookup_cuda(wam_pts, *_lookup_operands(wam_packed, True)),
                      flush=True)
    change = again[0] / default_ms - 1
    log(f"K3 default (f32 packed, no screen) again: {_spread(again)}, "
        f"{100 * change:+.2f}% against phase 5's {default_ms:.4f} ms")
    if abs(change) > 0.03:
        raise AssertionError(f"K3's default moved {100 * change:+.2f}% from phase 5")

    # the planar instantiations: PointRobot2D's queries on OneObstacle,
    # MultiWorld2D's 8192 worlds of 64^2, the edges
    rng = np.random.default_rng(15)
    ds = generate_2d_dataset("OneObstacleDataset")
    field = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    ext = np.array([ds.cols, ds.rows]) * ds.cell_size
    pts2 = torch.as_tensor(
        ds.origin + rng.uniform(-0.05, 1.05, (SUITE_BATCH["PointRobot2D"] * 61, 2)) * ext,
        dtype=f32, device=dev)
    n, Bw, qpw = 64, SUITE_BATCH["MultiWorld2D"], 33
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    cys = rng.uniform(-0.3, 0.3, Bw)
    data = np.sqrt(X[None] ** 2 + (Y[None] - cys[:, None, None]) ** 2) - 0.3
    worlds = PlanarSDF(torch.tensor([-1.5, -1.5], dtype=f32, device=dev),
                       torch.tensor(3.0 / (n - 1), dtype=f32, device=dev),
                       torch.as_tensor(data, dtype=f32, device=dev))
    ptsw = torch.as_tensor(rng.uniform(-1.6, 1.6, (Bw * qpw, 2)), dtype=f32, device=dev)
    for suffix, raw, pts, q, route in (("", field, pts2, 0, "interleaved"),
                                       ("_multiworld", worlds, ptsw, qpw, "direct")):
        cm, rm = pack_planar_sdf(raw, corner_major=True), pack_planar_sdf(raw)
        name = "OneObstacle" if not q else "MultiWorld"
        got = corner_major_route(pts.shape[0], max(raw.num_worlds, 1), raw.cells, 4)
        if got != route:
            raise AssertionError(f"K3 {name} corner-major: the {got} route, not {route}")
        check_lookup(f"{name} row-major f32", rm, pts, True, q)
        check_lookup(f"{name} corner-major ({route}) f32", cm, pts, True, q)
        check_lookup(f"{name} corner-major ({route}) f64", cm.to(dtype=torch.float64),
                     pts.double(), True, q)
        # the four corners of the distinct cells (of each world) read once,
        # 16 B either way
        timed("row_major_2d" + suffix, rm, pts, {}, lambda: k3_bound(pts, rm, qpw=q), q)
        timed("corner_major" + suffix, cm, pts, {"corner_major": True},
              lambda: k3_bound(pts, cm, qpw=q), q)
        variants["corner_major" + suffix]["route"] = route
        library = _grid_sample_2d_ms(raw, pts, q)
        for layout in ("row_major_2d", "corner_major"):
            variants[layout + suffix]["library_ms"] = library[0]
        log(f"K3 planar yardstick at N={pts.shape[0]}: F.grid_sample (distance only, no "
            f"gradient), device time, L2 flushed, {_spread(library)}")
    check_lookup_edges("OneObstacle corner-major", pack_planar_sdf(field, corner_major=True),
                       dev, (True,))
    return variants, again[0]


def variant_main_paths(dev, card, inputs):
    """The main path (phase 6's inputs, B_MAIN, LM, float32, best of
    REPEATS after a warm-up) once per option: float16 rows
    (GPMP2_TPU_PACK_DTYPE), the hull screen and the coarse screen. Each
    row gates at 0.95 converged and 0.99 collision-free and must launch
    K1-K3; the screened rows must equal the unscreened row lane for lane
    (final errors within rel 1e-6, the same converged flags). Returns each
    option's launches."""
    from unittest import mock

    import torch

    robot, sdf, setting, params, starts, goals = inputs
    want_dtype = {"pack_f16": torch.float16}
    res0 = timed_main_path("main path", path_solver(inputs, params)).res
    screens = _screens(dev, sdf)
    out = {}
    for name, pack_dtype, screen in VARIANT_PATHS:
        with mock.patch.dict(os.environ, {"GPMP2_TPU_PACK_DTYPE": pack_dtype}):
            field = sdf if screen is None else screens[screen]
            solve = path_solver((robot, field, setting, params, starts, goals), params)
            if solve.sdf.packed.dtype != want_dtype.get(name, torch.float32):
                raise AssertionError(f"{name}: packed as {solve.sdf.packed.dtype}")
            times, res, cc, launches, _ = timed_main_path(f"main path ({name})", solve)
            best = min(times)
        conv, free, conv_frac, free_frac = main_path_quality(name, res, cc)
        row = {"metric": f"wam7_lm_main_path_{name}", "batch": B_MAIN,
               "converged_frac": conv_frac, "collision_free_frac": free_frac,
               "mean_iters": float(res.iterations.float().mean()), "solve_time_s": best,
               "plans_per_s": float((conv & free).sum()) / best, "launches": launches,
               "card": card}
        if screen is not None:
            rel = ((res.error - res0.error).abs() / res0.error.abs()).max()
            row["max_rel_error_vs_unscreened"] = float(rel)
            row["bit_unequal_lanes"] = int((res.error != res0.error).sum())
            if not (float(rel) <= 1e-6 and torch.equal(res.converged, res0.converged)):
                raise AssertionError(f"{name}: the screened plans differ from the "
                                     f"unscreened ones: {row}")
        log(json.dumps(row))
        out[name] = launches
    return out


def corner_major_suite(dev, card, wam_sdf):
    """PointRobot2D and Arm3Limits2D at bench_suite.py's throughput batches
    with the corner-major planar table against the row-major one: the same
    corners through the same arithmetic, so equal errors, iterations and
    converged flags in every lane; K3 must launch. Returns their launches."""
    import torch
    from gpmp2_tpu_torch.obstacle.sdf import pack_planar_sdf
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem, plan_batch
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting

    out = {}
    for name, robot, setting, _, (sdf, s, g), kwargs in suite_configs(dev, wam_sdf):
        if name not in ("PointRobot2D", "Arm3Limits2D"):
            continue
        params = optimizer_params_from_setting(setting)
        z = torch.zeros_like(s)
        results = {}
        for layout in ("row_major", "corner_major"):
            field = pack_planar_sdf(sdf, corner_major=layout == "corner_major")
            probs = make_problem(robot, field, s, z, g, z, setting, **kwargs)
            init = init_traj_straight_line(probs.space, s, g, setting.total_step,
                                           setting.total_time)
            res, ms = best_of_3(lambda: plan_batch(probs, init, params))
            reset_launches()
            plan_batch(probs, init, params)
            torch.cuda.synchronize()
            results[layout] = (res, ms, read_launches())
        (r0, ms0, _), (r1, ms1, launches) = results["row_major"], results["corner_major"]
        same = (torch.equal(r0.error, r1.error) and torch.equal(r0.iterations, r1.iterations)
                and torch.equal(r0.converged, r1.converged))
        log(json.dumps({"config": f"{name}_corner_major", "batch": int(s.shape[0]),
                        "solve_ms": ms1, "row_major_solve_ms": ms0,
                        "lanes_equal": same, "launches": launches, "card": card}))
        if not same:
            raise AssertionError(f"{name}: the corner-major plans differ from the row-major")
        if launches["sdf_lookup"] == 0:
            raise AssertionError(f"{name}: K3 was not launched: {launches}")
        out[name] = launches
    return out


def sdf_variants_phase(dev, card, inputs, wam_pts, default_ms, suite_rows):
    """Phase 15: K3's variants against their plain versions and timed, the
    main path once per option, the corner-major suite rows. Returns the
    kernels' line's `variants`, with each option's K3 launches (the
    row-major planar default's from phase 8's suite rows), and the default
    instantiation's time in this phase."""
    robot, sdf, setting, *_ = inputs
    eps_total = robot.sphere_radii + setting.epsilon
    t0 = time.perf_counter()
    variants, again_ms = check_variant_lookups(dev, sdf, wam_pts, eps_total, default_ms)
    log(f"phase 15's kernel checks took {time.perf_counter() - t0:.1f} s")
    for name, launches in variant_main_paths(dev, card, inputs).items():
        variants[{"pack_f16": "f16", "screen_boxes": "hull", "screen_sdf": "coarse"}[name]][
            "launches_main_path"] = launches["sdf_lookup"]
    for name, launches in corner_major_suite(dev, card, sdf).items():
        variants["corner_major"][f"launches_{name}"] = launches["sdf_lookup"]
    for name in ("PointRobot2D", "Arm3Limits2D", "MultiWorld2D"):
        layout = "row_major_2d" + ("_multiworld" if name == "MultiWorld2D" else "")
        variants[layout][f"launches_{name}"] = suite_rows[name]["launches"]["sdf_lookup"]
    return variants, again_ms


# ---- phase 16: the measuring entry points ----------------------------------------

BENCH_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_torch.py")
SUITE_DUMP_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                 "oracle", "suite_dump_torch.py")
# bench_torch.py --config all's rows by mode
BENCH_ROWS = {"main": 1, "suite": 5, "replan": 1, "longhorizon": 2 * len(LH_NS)}


def bench_row_kernels(row):
    """The kernels a bench_torch.py row's path launches."""
    if row["mode"] == "longhorizon":
        return ("btsolve",)
    if row["mode"] == "suite" and row["config"] not in ("Arm3Limits2D", "WAM7_3D"):
        return ("btsolve", "sdf_lookup")
    return ("btsolve", "fk_arm", "sdf_lookup")


def bench_phase(card, main_metrics, suite_rows):
    """Phase 16: bench_torch.py --config all as its own script: every row
    with the card's line and the launches of its path's kernels, the main
    row's converged fraction and mean iterations equal to phase 6's and the
    suite rows' q512 fractions equal to phase 8's (the same draws through
    the same code); vs_baseline set where BASELINE_MEASURED_H100_HOST.json
    exists. Then tools/oracle/suite_dump_torch.py into a temporary
    directory, each file of the size its header gives."""
    import runpy
    import tempfile

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, BENCH_SCRIPT, "--config", "all"],
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        log(out.stdout[-3000:], out.stderr[-3000:])
        raise AssertionError(f"bench_torch.py --config all exited {out.returncode}")
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    for row in rows:
        log(json.dumps(row))
    counts = {mode: sum(r["mode"] == mode for r in rows) for mode in BENCH_ROWS}
    if counts != BENCH_ROWS:
        raise AssertionError(f"bench_torch.py: rows by mode {counts}, not {BENCH_ROWS}")
    for row in rows:
        name = row.get("metric", row.get("config"))
        if row["card"] != card:
            raise AssertionError(f"bench_torch.py {name}: card {row['card']!r}, not {card!r}")
        if any(row["launches"][k] == 0 for k in bench_row_kernels(row)):
            raise AssertionError(f"bench_torch.py {name}: a kernel of its path was not "
                                 f"launched: {row['launches']}")
    main_row = next(r for r in rows if r["mode"] == "main")
    for key in ("converged_frac", "mean_iters"):
        if main_row[key] != main_metrics[key]:
            raise AssertionError(f"bench_torch.py main {key} {main_row[key]} against phase "
                                 f"6's {main_metrics[key]}")
    have_baseline = os.path.exists(os.path.join(os.path.dirname(BENCH_SCRIPT),
                                                "BASELINE_MEASURED_H100_HOST.json"))
    if have_baseline != (main_row["vs_baseline"] is not None):
        raise AssertionError(f"bench_torch.py main vs_baseline {main_row['vs_baseline']} "
                             f"with the host baseline file present: {have_baseline}")
    suite_bench = [r for r in rows if r["mode"] == "suite"]
    if [r["config"] for r in suite_bench] != list(suite_rows):
        raise AssertionError(f"bench_torch.py suite configs {[r['config'] for r in suite_bench]}")
    for r in suite_bench:
        for key in ("q512_converged_frac", "q512_collision_free_frac"):
            if r[key] != suite_rows[r["config"]][key]:
                raise AssertionError(f"bench_torch.py {r['config']} {key} {r[key]} against "
                                     f"phase 8's {suite_rows[r['config']][key]}")
    log(f"bench_torch.py --config all: {len(rows)} rows in {wall:.1f} s, main and suite "
        f"equal to phases 6 and 8")

    expected_size = runpy.run_path(SUITE_DUMP_SCRIPT, run_name="suite_dump")["expected_size"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, SUITE_DUMP_SCRIPT, tmp], capture_output=True,
                             text=True, timeout=300)
        if out.returncode != 0:
            log(out.stdout[-3000:], out.stderr[-3000:])
            raise AssertionError(f"suite_dump_torch.py exited {out.returncode}")
        sizes = {}
        for name in sorted(os.listdir(tmp)):
            path = os.path.join(tmp, name)
            sizes[name] = os.path.getsize(path)
            if sizes[name] != expected_size(path, SUITE_BATCH["q512"]):
                raise AssertionError(f"suite_dump_torch.py {name}: {sizes[name]} bytes, not "
                                     f"{expected_size(path, SUITE_BATCH['q512'])}")
    if len(sizes) != 5:
        raise AssertionError(f"suite_dump_torch.py wrote {sorted(sizes)}")
    log(f"suite_dump_torch.py in {time.perf_counter() - t0:.1f} s: {sizes}")


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
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi_card()
    log(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    # 2. build
    t0 = time.perf_counter()
    _build.kernels_lib()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    # 3-5. kernels against their plain versions
    k1 = check_btsolve(dev)
    k2 = check_fk_arm(dev)
    inputs = main_path_inputs(dev)
    robot, sdf, setting, _, starts, goals = inputs
    wam_pts = main_path_queries(robot, sdf, setting, starts, goals)
    k3 = check_sdf_lookup(dev, sdf, wam_pts)
    assembly = check_assemble(dev, inputs)
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    # 6. main path
    main_metrics = main_path(dev, card, inputs)
    launches = main_metrics["launches"]

    # 7. reference agreement on a small input
    reference_agreement(dev, inputs)
    log(f"main path done at {time.perf_counter() - t_start:.1f} s")

    # 8. the bench_suite paths
    suite_rows = suite(dev, card, sdf)
    log(f"suite done at {time.perf_counter() - t_start:.1f} s")

    # 9. Dogleg on the main path's problems
    dogleg_phase(card, inputs)
    log(f"Dogleg done at {time.perf_counter() - t_start:.1f} s")

    # 10. the mobile manipulators
    k1.update(mobile_phase(dev, card, sdf))
    log(f"mobile manipulators done at {time.perf_counter() - t_start:.1f} s")

    # 11. incremental replanning
    replan_phase(dev, card, inputs)
    log(f"replanning done at {time.perf_counter() - t_start:.1f} s")

    # 12. the manual graphs
    graph_phase(dev, card, inputs)
    log(f"manual graphs done at {time.perf_counter() - t_start:.1f} s")

    # 13. SE(3) states and the remaining examples
    k1.update(se3_examples_phase(dev))
    log(f"SE(3) and the examples done at {time.perf_counter() - t_start:.1f} s")

    # 14. long horizon, the mesh and the sharded solves, batch_fleet
    phase14 = parallel_phase(dev, card)
    k1["launches_phase14"] = {"long_horizon": phase14["long_horizon"],
                              "ts_planner": phase14["ts_planner"]["btsolve"],
                              "batch_fleet": phase14["batch_fleet"]["btsolve"]}
    k2["launches_phase14"] = {"batch_fleet": phase14["batch_fleet"]["fk_arm"]}
    k3["launches_phase14"] = {"ts_planner": phase14["ts_planner"]["sdf_lookup"],
                              "batch_fleet": phase14["batch_fleet"]["sdf_lookup"]}
    log(f"long horizon and the mesh done at {time.perf_counter() - t_start:.1f} s")

    # 15. the opt-in SDF variants
    k3["variants"], k3["ms_phase15"] = sdf_variants_phase(dev, card, inputs, wam_pts,
                                                          k3["ms"], suite_rows)
    log(f"SDF variants done at {time.perf_counter() - t_start:.1f} s")

    # 16. the measuring entry points
    t0 = time.perf_counter()
    bench_phase(card, main_metrics, suite_rows)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s; measuring entry points done at "
        f"{time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "btsolve", "route": "cuda", "source": "gpmp2_tpu_torch/csrc/btsolve.cu",
         "replaces": "gpmp2_tpu/ops/btsolve.py:82", "launches": launches["btsolve"], **k1},
        {"name": "fk_arm", "route": "cuda", "source": "gpmp2_tpu_torch/csrc/fk_arm.cu",
         "replaces": "gpmp2_tpu/ops/fk_arm.py:62", "launches": launches["fk_arm"], **k2},
        {"name": "sdf_lookup", "route": "cuda", "source": "gpmp2_tpu_torch/csrc/sdf_lookup.cu",
         "replaces": "profile_dma_gather.py:214 (and P1-P8: profile_dma2.py:120,181, "
                     "profile_dma3.py:60, profile_dma4.py:82-146, profile_dma5.py:83-158, "
                     "profile_dma6.py:61-166, profile_dma7.py:58, profile_dma8.py:68,146, "
                     "profile_dma9.py:78)",
         "launches": launches["sdf_lookup"], **k3},
        {"name": "assemble_vec", "route": "cuda",
         "source": "gpmp2_tpu_torch/csrc/assemble_vec.cu", "replaces": None,
         "launches": launches["assemble"], **assembly},
    ]
    log("recorded times, not measured in this run: "
        + ", ".join(f"{name} {ms} ms" for name, ms in RECORDED_PREV_MS.items())
        + " before the current designs (PERF.md's kernel table)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

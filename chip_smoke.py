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
   points on the top faces, outside the grid and NaN;
6. the main path of bench.py through the port's entry points: the WAM
   7-DOF arm, the 300^3 WAMDeskDataset SDF packed on the device, B = 2048
   rejection-sampled collision-free endpoints (numpy seed 0), LM with
   max_iter 50 and rel_thresh 1e-2 in float32, best of 3 after a warm-up;
   K1, K2 and K3 must each launch during the solve;
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
   mobile FK is plain torch, so K2 launches 0 times in this phase.

It prints one informational JSON line of main-path metrics, one per suite
config, one for the Dogleg phase, one per mobile-manipulator row, a line
of K1's and K2's recorded times before their current designs (not
measured in the run), the kernels' JSON line (K1's entry with its m = 36
times), and last `{"ok": true, "device": {...}}`.
Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
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


def bound(nbytes, flops, flops_per_s=F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ms = cuda_ms(lambda: block_tridiag_solve_cuda(D, U, b, True, lam), 50)
    D1, U1, b1, lam1 = (t[:1].contiguous() for t in (D, U, b, lam))
    ms_b1 = cuda_ms(lambda: block_tridiag_solve_cuda(D1, U1, b1, True, lam1), 50)
    # MobileBaseSE2's shape with lambda = 0, as Dogleg's Gauss-Newton point
    Dm, Um, bm, lm = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in random_system(4096, 16, 6, seed=2, damped=False))
    ms_m6 = cuda_ms(lambda: block_tridiag_solve_cuda(Dm, Um, bm, True, lm), 50)
    m6_bound, m6_by = bound(4 * (Dm.numel() + Um.numel() + 2 * bm.numel() + lm.numel()),
                            4096 * 16 * (6**3 / 3 + 4 * 36 * 7 + 2 * 36))
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
    # inputs D, U, b, lam read once and x written once; the flop count is
    # that of the block recurrence (per block: Cholesky m^3/3, the [U | z]
    # solve and the U^T X carry 4 m^2 (m + 1), back substitution 2 m^2)
    nbytes = 4 * (D.numel() + U.numel() + b.numel() + lam.numel() + b.numel())
    bound_ms, bound_by = bound(nbytes, B * n * (m**3 / 3 + 4 * m * m * (m + 1) + 2 * m * m))
    log(f"K1 time at B={B} n={n} m={m} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.linalg.solve dense {library_ms:.4f} ms (max|dx| vs K1 {lib_err:.2e}), "
        f"bound {bound_ms:.4f} ms ({bound_by}); kernel at B=1 {ms_b1:.4f} ms; at "
        f"B=4096 n=16 m=6 lambda=0 {ms_m6:.4f} ms (bound {m6_bound:.4f} ms, {m6_by})")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "ms_b1": ms_b1, "ms_m6_b4096": ms_m6}


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
    ms = cuda_ms(lambda: arm_fk_spheres_cuda(*ops, q), 20)
    plain_ms = cuda_ms(lambda: fk_spheres_torch(*ops, q), 10)
    S, d = 16, 7
    nbytes = 4 * n_main * (d + S * 3 + S * 3 * d)
    bound_ms, bound_by = bound(nbytes, n_main * (40 * d + S * (12 + 9 * d)))
    log(f"K2 time at N={n_main} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
    or its raw samples."""
    t = sdf.packed.reshape(-1, 2 ** sdf.DIM) if packed else sdf.data.reshape(-1)
    return t, sdf.origin, sdf.cell_size, sdf.grid


def check_lookup(name, sdf, pts, packed, qpw=0):
    """K3 on `pts` (N, >= dim) against its plain version in float64 on the
    same rounded inputs (relative tolerance 1e-4 in float32: the cell
    coordinate carries a float32 rounding of ~2e-5 cells, which moves the
    gradient weights; 1e-12 in float64), and a float32 kernel also against
    the plain version in float32 on every query (1e-5: the same cells,
    other rounding). Returns the largest difference."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    tol = 1e-4 if pts.dtype == torch.float32 else 1e-12
    got = sdf_lookup_cuda(pts, *_lookup_operands(sdf, packed), qpw)
    torch.cuda.synchronize()
    s64 = (sdf if packed else dataclasses.replace(sdf, packed=None)).to(dtype=torch.float64)
    ref = sdf_lookup_torch(pts.double(), *_lookup_operands(s64, packed), qpw)
    if pts.dtype == torch.float32:
        c = _cell_coords(pts.double(), sdf)
        near = ((c - c.round()).abs() < 1e-4).any(-1)
        # and every query against the plain version in float32, which
        # picks the same cells: only FMA contraction differs
        same = sdf_lookup_torch(pts, *_lookup_operands(sdf, packed), qpw)
        _compare_lookup(name + " (plain f32)", got, same, torch.zeros_like(near), 1e-5)
    else:
        near = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    return _compare_lookup(name, got, ref, near, tol)


def check_sdf_lookup(dev, wam_sdf, wam_pts):
    """K3 against its plain version (check_lookup) at the main path's, the
    suite's and the edges' queries; timed at the main path's."""
    import dataclasses

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

    # edges: the low and top faces, one step outside each, and NaN, on the
    # two fields moved to a dyadic grid (origin -1, cell 1/128), where the
    # face points are exact in both dtypes
    for name, field in (("WAM", wam_packed), ("OneObstacle", planar)):
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
        for dtype in (f32, f64):
            s = sdf.to(dtype=dtype)
            p = pts.to(dtype)
            for packed in (True, False):
                got = sdf_lookup_cuda(p, *_lookup_operands(s, packed))
                ref = sdf_lookup_torch(p, *_lookup_operands(s, packed))
                want_ok = [True] * 3 + [True, False] * (2 * sdf.DIM) + [False]
                if got[-1].tolist() != want_ok or ref[-1].tolist() != want_ok:
                    raise AssertionError(f"K3 {name} edges {dtype}: in-range mask "
                                         f"{got[-1].tolist()}")
                for g, r in zip(got[:-1], ref[:-1]):
                    if not torch.allclose(g, r, rtol=1e-5, atol=1e-6, equal_nan=True):
                        raise AssertionError(f"K3 {name} edges {dtype} packed={packed}")
                if not bool(torch.isnan(got[0][-1])):
                    raise AssertionError(f"K3 {name} edges: NaN query gave {got[0][-1]}")
        log(f"K3 {name} edges: faces, outside and NaN agree (f32, f64, packed, raw)")

    table, origin, cell, grid = _lookup_operands(wam_packed, True)
    ms = cuda_ms(lambda: sdf_lookup_cuda(wam_pts, table, origin, cell, grid), 20)
    plain_ms = cuda_ms(lambda: sdf_lookup_torch(wam_pts, table, origin, cell, grid), 5)
    # bytes: the points read once, the distinct packed rows these queries
    # touch read once, the four outputs and the mask written once
    c = _cell_coords(wam_pts.double(), wam_packed).clamp(min=0)
    nz, rows, cols = grid
    lo = [c[:, k].floor().clamp(max=s - 2).long() for k, s in enumerate((cols, rows, nz))]
    touched = int(torch.unique((lo[2] * rows + lo[1]) * cols + lo[0]).numel())
    N = wam_pts.shape[0]
    nbytes = N * 3 * 4 + touched * 32 + N * (4 * 4 + 1)
    bound_ms, bound_by = bound(nbytes, N * 120)
    log(f"K3 time at N={N} f32 packed (WAM main path): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {touched} distinct rows)")
    grid_sample_ms = _grid_sample_ms(wam_sdf, wam_pts)
    log(f"K3 yardstick: F.grid_sample (distance only, no gradient) {grid_sample_ms:.4f} ms")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _grid_sample_ms(sdf, pts):
    """Time of F.grid_sample's trilinear distance (no gradient) at the same
    queries: a yardstick only, no function of the port's."""
    import torch
    import torch.nn.functional as F

    nz, rows, cols = sdf.grid
    size = torch.tensor([cols - 1, rows - 1, nz - 1], dtype=pts.dtype, device=pts.device)
    g = (2 * (pts - sdf.origin) / sdf.cell_size / size - 1).reshape(1, 1, 1, -1, 3)
    vol = sdf.data[None, None]
    return cuda_ms(lambda: F.grid_sample(vol, g, mode="bilinear", align_corners=True), 20)


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
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda

    for fn in (block_tridiag_solve_cuda, arm_fk_spheres_cuda, sdf_lookup_cuda):
        fn.launches = 0


def read_launches():
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda
    from gpmp2_tpu_torch.ops.fk_arm import arm_fk_spheres_cuda
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda

    return {"btsolve": block_tridiag_solve_cuda.launches,
            "fk_arm": arm_fk_spheres_cuda.launches,
            "sdf_lookup": sdf_lookup_cuda.launches}


def path_solver(inputs, params):
    """solve(b): the first b main-path problems built through the entry
    points (on the SDF packed once), planned from the straight line with
    `params`, and their collision costs, ending in a synchronize."""
    import torch
    from gpmp2_tpu_torch.planner import (collision_cost, init_traj_straight_line,
                                         make_problem, plan_batch)

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
        torch.cuda.synchronize()
        return res, cc
    return solve


def main_path(dev, card, inputs):
    import torch

    solve = path_solver(inputs, inputs[3])
    solve(B_MAIN)  # warm-up
    times = []
    for _ in range(REPEATS):
        reset_launches()
        t0 = time.perf_counter()
        res, cc = solve(B_MAIN)
        times.append(time.perf_counter() - t0)
        launches = read_launches()
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
        "launches": launches,
        "card": card,
    }
    log(json.dumps(metrics))
    return launches


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


def suite_configs(dev, wam_sdf):
    """bench_suite.py's configurations and draws, in its order: for each
    config, (name, robot, setting, (q512 sdf, starts, goals), (throughput
    sdf, starts, goals), make_problem keywords). numpy seed 0 draws the
    oracle's 512-problem sets, seed 1 the throughput batches."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.kinematics.fk import PointRobotFK
    from gpmp2_tpu_torch.kinematics.robot import make_robot_model
    from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting
    from gpmp2_tpu_torch.robots import generate_arm, generate_mobile_base

    f32 = torch.float32
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=f32, device=dev)  # noqa: E731
    rng, rng_t = np.random.default_rng(0), np.random.default_rng(1)
    Bq = SUITE_BATCH["q512"]
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
                (sdf2, *draw_pr(rng_t, SUITE_BATCH["PointRobot2D"])), {}))

    dsm = generate_2d_dataset("MobileMap1")
    sdfm = planar_sdf_from_occupancy(dsm.origin, dsm.cell_size, dsm.map, device=dev)
    out.append(("MobileBaseSE2", generate_mobile_base(device=dev), mobile_setting(),
                (sdfm, *map(t, draw_mobile(rng, Bq))),
                (sdfm, *map(t, draw_mobile(rng_t, SUITE_BATCH["MobileBaseSE2"]))),
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
                (sdf2, *draw_a3(rng_t, SUITE_BATCH["Arm3Limits2D"])), {}))

    wam = generate_arm("WAMArm", device=dev)
    setting_w = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, cost_sigma=0.02, obs_check_inter=9,
        opt_type="lm", max_iter=50, rel_thresh=1e-2, Qc=np.eye(7))

    def draw_w(r, n):
        return (t(BASE_START + 0.03 * r.normal(size=(n, 7))),
                t(BASE_GOAL + 0.03 * r.normal(size=(n, 7))))
    out.append(("WAM7_3D", wam, setting_w, (wam_sdf, *draw_w(rng, Bq)),
                (wam_sdf, *draw_w(rng_t, SUITE_BATCH["WAM7_3D"])), {}))

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
                draw_mw(rng_t, SUITE_BATCH["MultiWorld2D"]), {}))
    return out


def suite(dev, card, wam_sdf):
    """The bench_suite.py paths, each config's line and gates."""
    import dataclasses

    import torch
    from gpmp2_tpu_torch.planner import (collision_cost, init_traj_straight_line,
                                         make_problem, plan_batch)
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "BASELINE_MEASURED_SUITE.json")) as fh:
        oracles = json.load(fh)["configs"]
    for name, robot, setting, qset, tset, kwargs in suite_configs(dev, wam_sdf):
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
        run(probs_t, init_t, params)  # warm-up
        best = float("inf")
        for _ in range(REPEATS):
            reset_launches()
            t_run, (conv, gave, free, iters) = run(probs_t, init_t, params)
            best = min(best, t_run)
            launches = read_launches()
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
            "launches": launches, "card": card,
        }
        log(json.dumps(row))
        need = ["btsolve", "sdf_lookup"] + (["fk_arm"] if name in ("Arm3Limits2D", "WAM7_3D")
                                            else [])
        if any(launches[k] == 0 for k in need):
            raise AssertionError(f"{name}: a kernel of its path was not launched: {launches}")
        if row["q512_converged_frac"] < row["oracle_q512_converged_frac"]:
            raise AssertionError(f"{name}: q512 converged {row['q512_converged_frac']} < "
                                 f"the oracle's {row['oracle_q512_converged_frac']}")
        if abs(row["q512_collision_free_frac"] - row["oracle_q512_collision_free_frac"]) > 0.02:
            raise AssertionError(f"{name}: q512 collision-free "
                                 f"{row['q512_collision_free_frac']} not within 0.02 of "
                                 f"the oracle's {row['oracle_q512_collision_free_frac']}")


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
                elem = D.element_size()
                nbytes = elem * (D.numel() + U.numel() + 2 * b.numel() + lam.numel())
                bound_ms, bound_by = bound(
                    nbytes, B * n * (m**3 / 3 + 4 * m * m * (m + 1) + 2 * m * m), peak)
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


def two_links_world(dev, dtype):
    """tests/fixtures/oracle_replan_mobilearm.npz's world and graph:
    SimpleTwoLinksArm in a one-box 300^2 planar field, 10 intervals, no
    interpolated states, cost_sigma 0.1, eps 0.2, LM at the fixture's
    rel_tol."""
    from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import TrajOptimizerSetting
    from gpmp2_tpu_torch.robots import generate_mobile_arm

    here = os.path.dirname(os.path.abspath(__file__))
    fx = np.load(os.path.join(here, "tests", "fixtures", "oracle_replan_mobilearm.npz"))
    occ = np.zeros((300, 300))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    sdf = planar_sdf_from_occupancy(fx["meta_origin"], float(fx["meta_cell"]), occ,
                                    dtype=dtype, device=dev)
    setting = TrajOptimizerSetting(
        dof=5, total_step=int(fx["meta_n_steps"]), total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]), cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]), opt_type="lm", max_iter=100,
        rel_thresh=float(fx["meta_rel_tol"]))
    return fx, generate_mobile_arm("SimpleTwoLinksArm", dtype=dtype, device=dev), sdf, setting


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

    fx, robot, sdf, setting = two_links_world(dev, torch.float32)
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

    fx, robot, sdf, setting = two_links_world(dev, torch.float64)
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

    fx, robot, sdf, setting = two_links_world(dev, torch.float32)
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

    # 3-5. kernels against their plain versions
    k1 = check_btsolve(dev)
    k2 = check_fk_arm(dev)
    inputs = main_path_inputs(dev)
    robot, sdf, setting, _, starts, goals = inputs
    k3 = check_sdf_lookup(dev, sdf, main_path_queries(robot, sdf, setting, starts, goals))
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    # 6. main path
    launches = main_path(dev, card, inputs)

    # 7. reference agreement on a small input
    reference_agreement(dev, inputs)
    log(f"main path done at {time.perf_counter() - t_start:.1f} s")

    # 8. the bench_suite paths
    suite(dev, card, sdf)
    log(f"suite done at {time.perf_counter() - t_start:.1f} s")

    # 9. Dogleg on the main path's problems
    dogleg_phase(card, inputs)
    log(f"Dogleg done at {time.perf_counter() - t_start:.1f} s")

    # 10. the mobile manipulators
    k1.update(mobile_phase(dev, card, sdf))
    log(f"mobile manipulators done at {time.perf_counter() - t_start:.1f} s")

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

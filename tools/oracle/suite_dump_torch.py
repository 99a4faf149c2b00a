"""Dump bench_suite.py's problem sets for the C++ suite oracle, from the
PyTorch port's dataset and robot constructors.

The twin of tools/oracle/suite_dump.py: one self-describing binary per
suite config holding the exact SDF grid, robot model, optimizer settings
and the B sampled start/goal pairs that bench_suite.py and bench_torch.py
solve (numpy seed 0, drawn in bench_suite.py's order), so that the
single-threaded C++ oracle (gpmp2_oracle_suite.cpp, and gpmp2_oracle.cpp
--probs for the WAM) solves the identical problems. The files equal
suite_dump.py's byte for byte.

Format (little-endian): ASCII header of `key value` lines terminated by a
single line `end`, then raw arrays in this order (float64 unless noted):
  dh_a[dof] dh_alpha[dof] dh_d[dof]            (family=arm only)
  spheres[S*5]  (link, cx, cy, cz, radius)
  pos_down[dof] pos_up[dof] pos_thresh[dof]    (has_limits=1 only)
  vel_lim[dof] vel_thresh[dof]                 (has_limits=1 only)
  starts[B*dof] goals[B*dof]
  sdf_data[(per_plan ? B : 1) * rows * cols]   (float32, row-major (Y, X))
wam7_probs.bin holds only starts[B*7] then goals[B*7], float64.

Usage: python tools/oracle/suite_dump_torch.py [outdir] [--cpu]
(default outdir: build/oracle_dumps/ in the repository, which git ignores;
SUITE_BATCH sets B, default 512). The fields and robots are built on the
card unless --cpu is given; without a CUDA device and without --cpu it
exits non-zero.
"""

import os
import sys

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, REPO)

DEFAULT_OUT = os.path.join(REPO, "build", "oracle_dumps")
FILES = ("pointrobot2d.bin", "mobilebase_se2.bin", "arm3limits2d.bin", "wam7_probs.bin",
         "multiworld2d.bin")
BASE_START = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
BASE_GOAL = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])


def write_config(path, *, family, dof, n_steps, inter, total_time,
                 cost_sigma, eps, prior_sigma, starts, goals, spheres,
                 sdf_origin, sdf_cell, sdf_data, per_plan=False, dh=None,
                 limits=None, dyn_sigma=0.0):
    starts = np.asarray(starts, np.float64)
    goals = np.asarray(goals, np.float64)
    B = starts.shape[0]
    S = len(spheres)
    sdf_data = np.asarray(sdf_data, np.float32)
    rows, cols = sdf_data.shape[-2], sdf_data.shape[-1]
    with open(path, "wb") as f:
        def w(key, val):
            f.write(f"{key} {val}\n".encode())

        w("family", family)  # 0 point, 1 arm, 2 se2base
        w("dof", dof)
        w("n_steps", n_steps)
        w("inter", inter)
        w("B", B)
        w("S", S)
        w("has_limits", 1 if limits is not None else 0)
        w("has_dynamics", 1 if dyn_sigma > 0 else 0)
        w("per_plan_sdf", 1 if per_plan else 0)
        w("rows", rows)
        w("cols", cols)
        w("total_time", repr(float(total_time)))
        w("cost_sigma", repr(float(cost_sigma)))
        w("eps", repr(float(eps)))
        w("prior_sigma", repr(float(prior_sigma)))
        w("dyn_sigma", repr(float(dyn_sigma)))
        w("origin_x", repr(float(sdf_origin[0])))
        w("origin_y", repr(float(sdf_origin[1])))
        w("cell", repr(float(sdf_cell)))
        f.write(b"end\n")
        if family == 1:
            for arr in dh:  # a, alpha, d
                np.asarray(arr, np.float64).tofile(f)
        np.asarray(spheres, np.float64).tofile(f)
        if limits is not None:
            for arr in limits:  # down, up, pthresh, vlim, vthresh
                np.asarray(arr, np.float64).tofile(f)
        starts.tofile(f)
        goals.tofile(f)
        sdf_data.tofile(f)
    print(f"wrote {path} ({os.path.getsize(path)/1e6:.1f} MB)")


def read_header(path):
    """(the header's `key value` pairs as strings, its length in bytes)."""
    head = {}
    with open(path, "rb") as f:
        for line in f:
            if line == b"end\n":
                return head, f.tell()
            key, val = line.decode().split(" ", 1)
            head[key] = val.strip()
    raise ValueError(f"{path}: no `end` line")


def expected_size(path, B):
    """The byte size a dump of B problems must have: from its header, whose
    B must be `B` (wam7_probs.bin has none: 2 B 7 doubles)."""
    if os.path.basename(path) == "wam7_probs.bin":
        return 8 * 2 * B * 7
    head, nbytes = read_header(path)
    if int(head["B"]) != B:
        raise ValueError(f"{path}: B {head['B']}, not {B}")
    dof, S = int(head["dof"]), int(head["S"])
    doubles = (3 * dof if head["family"] == "1" else 0) + 5 * S + 2 * B * dof
    doubles += 5 * dof if head["has_limits"] == "1" else 0
    worlds = B if head["per_plan_sdf"] == "1" else 1
    return nbytes + 8 * doubles + 4 * worlds * int(head["rows"]) * int(head["cols"])


def dump(outdir, B, dev):
    """Write the five files into `outdir`, the fields and robots built on
    `dev`."""
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.device import host_array as host
    from gpmp2_tpu_torch.robots import generate_arm

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)  # bench_suite.py's seed and draw order

    # ---- 1. PointRobot2D (bench_suite.py config 1) ----------------------
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf2 = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    starts = np.stack([rng.uniform(-0.9, -0.5, B), rng.uniform(-0.9, 0.0, B)], -1)
    goals = np.stack([rng.uniform(1.4, 1.8, B), rng.uniform(1.2, 1.8, B)], -1)
    write_config(
        os.path.join(outdir, "pointrobot2d.bin"), family=0, dof=2,
        n_steps=10, inter=5, total_time=10.0, cost_sigma=0.1, eps=0.2,
        prior_sigma=1e-4, starts=starts, goals=goals,
        spheres=[[0, 0.0, 0.0, 0.0, 0.08]],
        sdf_origin=host(sdf2.origin), sdf_cell=float(sdf2.cell_size),
        sdf_data=host(sdf2.data),
    )

    # ---- 2. MobileBaseSE2 ----------------------------------------------
    dsm = generate_2d_dataset("MobileMap1")
    sdfm = planar_sdf_from_occupancy(dsm.origin, dsm.cell_size, dsm.map, device=dev)
    starts_m = np.stack([rng.uniform(-3.5, -2.5, B), rng.uniform(-3.5, -2.5, B),
                         rng.uniform(-0.5, 0.5, B)], -1)
    goals_m = np.stack([rng.uniform(2.5, 3.5, B), rng.uniform(2.5, 3.5, B),
                        rng.uniform(1.0, 2.0, B)], -1)
    write_config(
        os.path.join(outdir, "mobilebase_se2.bin"), family=2, dof=3,
        n_steps=15, inter=3, total_time=15.0, cost_sigma=0.01, eps=0.2,
        prior_sigma=1e-4, starts=starts_m, goals=goals_m,
        spheres=[[0, 0.0, 0.0, 0.0, 0.35]],
        sdf_origin=host(sdfm.origin), sdf_cell=float(sdfm.cell_size),
        sdf_data=host(sdfm.data), dyn_sigma=0.001,
    )

    # ---- 3. Arm3Limits2D ------------------------------------------------
    arm3 = generate_arm("SimpleThreeLinksArm", device=dev)
    starts_a = 0.2 * rng.normal(size=(B, 3))
    goals_a = np.array([np.pi / 2, 0, 0]) + 0.2 * rng.normal(size=(B, 3))
    sph = np.concatenate(
        [host(arm3.sphere_link_ids)[:, None], host(arm3.sphere_centers),
         host(arm3.sphere_radii)[:, None]], axis=1)
    write_config(
        os.path.join(outdir, "arm3limits2d.bin"), family=1, dof=3,
        n_steps=10, inter=5, total_time=5.0, cost_sigma=0.1, eps=0.2,
        prior_sigma=1e-4, starts=starts_a, goals=goals_a, spheres=sph,
        sdf_origin=host(sdf2.origin), sdf_cell=float(sdf2.cell_size),
        sdf_data=host(sdf2.data),
        dh=(host(arm3.fk.a), host(arm3.fk.alpha), host(arm3.fk.d)),
        limits=(np.full(3, -np.pi), np.full(3, np.pi), np.full(3, 1e-3),
                np.full(3, 1.5), np.full(3, 1e-3)),
    )

    # ---- 4. WAM7_3D: raw starts/goals for gpmp2_oracle.cpp --probs ------
    starts_w = BASE_START + 0.03 * rng.normal(size=(B, 7))
    goals_w = BASE_GOAL + 0.03 * rng.normal(size=(B, 7))
    wam_path = os.path.join(outdir, "wam7_probs.bin")
    with open(wam_path, "wb") as f:
        starts_w.astype(np.float64).tofile(f)
        goals_w.astype(np.float64).tofile(f)
    print(f"wrote {wam_path} ({os.path.getsize(wam_path)/1e6:.1f} MB)")

    # ---- 5. MultiWorld2D ------------------------------------------------
    n = 64
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    cys = rng.uniform(-0.3, 0.3, B)
    data = np.stack([np.sqrt(X**2 + (Y - c) ** 2) - 0.3 for c in cys])
    starts_mw = np.stack([np.full(B, -0.9), rng.uniform(-0.3, 0.3, B)], -1)
    goals_mw = np.stack([np.full(B, 0.9), rng.uniform(-0.3, 0.3, B)], -1)
    write_config(
        os.path.join(outdir, "multiworld2d.bin"), family=0, dof=2,
        n_steps=8, inter=3, total_time=4.0, cost_sigma=0.1, eps=0.2,
        prior_sigma=1e-4, starts=starts_mw, goals=goals_mw,
        spheres=[[0, 0.0, 0.0, 0.0, 0.05]],
        sdf_origin=np.asarray([-1.5, -1.5]), sdf_cell=3.0 / (n - 1),
        sdf_data=data, per_plan=True,
    )


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from gpmp2_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if "--cpu" in argv else None)
    dirs = [a for a in argv if a != "--cpu"]
    dump(dirs[0] if dirs else DEFAULT_OUT, int(os.environ.get("SUITE_BATCH", "512")), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

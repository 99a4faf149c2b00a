"""WAM 7-DOF planning in the WAMDeskDataset world.

Port of examples/wam_planner.py (WAMPlannerExample.m:13-175, the canonical
benchmark config): WAMDeskDataset -> EDT SDF -> WAMArm ->
batch_traj_optimize with total_time 2 s, 10 steps, 100 collision-checked
states, cost_sigma 0.02, timed with Timer; then the optimized trajectory
densified with interpolate_traj and its collision cost.

Run: python examples_torch/wam_planner.py [--cpu]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, batch_traj_optimize,  # noqa: E402
                                     collision_cost, interpolate_traj, make_problem)
from gpmp2_tpu_torch.robots import generate_arm  # noqa: E402
from gpmp2_tpu_torch.utils import Timer  # noqa: E402


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    robot = generate_arm("WAMArm", device=dev)

    print("building WAMDeskDataset + signed distance field ...")
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)

    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=9, opt_type="lm", max_iter=100, rel_thresh=1e-3, Qc=np.eye(7))

    start = torch.tensor([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2], device=dev)
    goal = torch.tensor([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55], device=dev)
    zero = torch.zeros(7, device=dev)

    timer = Timer("plan")
    timer.tic()
    res = batch_traj_optimize(robot, sdf, start, zero, goal, zero, setting)
    timer.toc(res.error)
    timer.print()

    prob = make_problem(robot, sdf, start[None], zero[None], goal[None], zero[None], setting)
    dense = interpolate_traj(robot.space, res.traj, np.eye(7), 0.2, 9)
    cc = float(collision_cost(prob, dense.pose[None])[0])
    print(f"converged: {bool(res.converged)}  iters: {int(res.iterations)}")
    print(f"graph error: {float(res.error):.2f}  dense collision cost: {cc:.6f}")
    print("support configurations:")
    print(res.traj.pose.cpu().numpy().round(3))


if __name__ == "__main__":
    main()

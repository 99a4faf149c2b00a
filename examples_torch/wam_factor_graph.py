"""WAM 7-DOF, factor graph assembled by hand on the 3D desk world.

Port of examples/wam_factor_graph.py (WAMFactorGraphExample.m): the graph
the batch planner builds internally, start and goal priors, GP priors, 3D
SDF obstacle factors and GP-interpolated obstacle factors (total_check
100), pushed one factor at a time through FactorGraph, then optimized with
LM. On the card the obstacle factors run kernels K2 and K3 and the solve
kernel K1.

Run: python examples_torch/wam_factor_graph.py [--cpu]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch import FactorGraph, OptimizerParams, generate_arm  # noqa: E402
from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.obstacle import obstacle_factor_error  # noqa: E402
from gpmp2_tpu_torch.planner import init_traj_straight_line  # noqa: E402


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    # WAMDeskDataset -> EDT SDF (WAMFactorGraphExample.m:13-26)
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    arm = generate_arm("WAMArm", device=dev)

    # settings (lines 42-60)
    total_time, n_steps, total_check = 2.0, 10, 100
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    Qc = np.eye(7)
    cost_sigma, eps = 0.02, 0.2

    start = torch.tensor([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2], device=dev)
    goal = torch.tensor([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55], device=dev)
    zero = torch.zeros(7, device=dev)

    g = FactorGraph(arm.space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(1, n_steps + 1):
        g.add_gp_prior(i - 1, i, dt, Qc)
        g.add_obstacle(i, arm, sdf, cost_sigma, eps)
        for j in range(1, check_inter + 1):
            tau = j * (total_time / total_check)
            g.add_obstacle_gp(i - 1, i, arm, sdf, cost_sigma, eps, Qc, dt, tau)

    init = init_traj_straight_line(arm.space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    res = g.optimize(init, OptimizerParams(method="lm", max_iter=100, rel_thresh=1e-4))
    print(f"Final Error = {float(res.error):.4f}  "
          f"({int(res.iterations)} iterations, converged={bool(res.converged)})")

    # collision check along the optimized support states (eps = 0 hinge)
    worst = float(obstacle_factor_error(arm, sdf, res.traj.pose, 0.0).sum(-1).max())
    print(f"max per-state collision cost (eps=0): {worst:.6f}")


if __name__ == "__main__":
    main()

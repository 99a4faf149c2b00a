"""Two-link planar arm, factor graph assembled by hand.

Port of examples/arm2_factor_graph.py (Arm2FactorGraphExample.m): the
OneObstacleDataset world, then the graph factor by factor through
FactorGraph (start and goal priors, GP priors per interval, planar
obstacle factors per state, GP-interpolated obstacle factors), handed to
Gauss-Newton, or to Dogleg with --dogleg (Arm2FactorGraphExample.m:76-148).

Run: python examples_torch/arm2_factor_graph.py [--cpu] [--dogleg]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch import FactorGraph, OptimizerParams, generate_arm  # noqa: E402
from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.planner import init_traj_straight_line  # noqa: E402


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    # dataset + SDF (Arm2FactorGraphExample.m:13-27)
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)

    # settings (lines 29-47)
    total_time, n_steps, total_check = 5.0, 10, 50
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    arm = generate_arm("SimpleTwoLinksArm", device=dev)
    Qc = np.eye(2)
    cost_sigma, eps = 0.1, 0.1

    start = torch.tensor([0.0, 0.0], device=dev)
    goal = torch.tensor([np.pi / 2, 0.0], device=dev)
    zero = torch.zeros(2, device=dev)

    # manual graph assembly (lines 76-120)
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

    # GaussNewton by default, Dogleg with --dogleg (lines 136-148)
    method = "dogleg" if "--dogleg" in sys.argv else "gaussnewton"
    res = g.optimize(init, OptimizerParams(method=method, max_iter=100, rel_thresh=1e-5))
    print(f"Final Error = {float(res.error):.4f}  ({int(res.iterations)} iterations, "
          f"method={method}, converged={bool(res.converged)})")
    for i, q in enumerate(res.traj.pose.cpu().numpy()):
        print(f"  x_{i}: [{q[0]: .4f}, {q[1]: .4f}]")


if __name__ == "__main__":
    main()

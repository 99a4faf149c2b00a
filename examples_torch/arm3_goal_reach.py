"""Three-link arm reaching a workspace goal with an unconstrained end
configuration.

Port of examples/arm3_goal_reach.py (Arm3GoalReachExample.m): no
end-configuration prior, a GoalFactorArm pins the end effector to the
workspace point (0, 1.1, 0) (goal sigma 1e-4), with a zero end-velocity
prior, GP priors and planar obstacle factors on the OneObstacleDataset
world. The optimizer may end in any configuration whose end effector
reaches the point.

Run: python examples_torch/arm3_goal_reach.py [--cpu]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch import FactorGraph, OptimizerParams, generate_arm  # noqa: E402
from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.kinematics import link_poses  # noqa: E402
from gpmp2_tpu_torch.planner import init_traj_straight_line  # noqa: E402


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    # float64 as in GTSAM: from the all-zeros start the arm is singular
    # (every end-effector Jacobian column points along +y) and the 1e8 goal
    # weight makes the first Newton systems too ill-conditioned for float32
    f64 = torch.float64
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=f64, device=dev)

    # settings (Arm3GoalReachExample.m:29-74)
    total_time, n_steps, total_check = 5.0, 10, 50
    dt = total_time / n_steps
    check_inter = total_check // n_steps - 1
    arm = generate_arm("SimpleThreeLinksArm", dtype=f64, device=dev)
    Qc = np.eye(3)
    cost_sigma, eps = 0.1, 0.1
    goal_point = np.array([0.0, 1.1, 0.0])

    start = torch.zeros(3, dtype=f64, device=dev)
    zero = torch.zeros(3, dtype=f64, device=dev)

    g = FactorGraph(arm.space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    # no end-configuration prior: the workspace goal and a zero end velocity
    g.add_goal(n_steps, arm.fk, goal_point, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(1, n_steps + 1):
        g.add_gp_prior(i - 1, i, dt, Qc)
        g.add_obstacle(i, arm, sdf, cost_sigma, eps)
        for j in range(1, check_inter + 1):
            tau = j * (total_time / total_check)
            g.add_obstacle_gp(i - 1, i, arm, sdf, cost_sigma, eps, Qc, dt, tau)

    init = init_traj_straight_line(arm.space, start, start, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    # Dogleg: from the straight-arm start, pure GN oscillates in the
    # singular direction and LM's lambda blows past its cap; the trust
    # region walks the bend in smoothly
    res = g.optimize(init, OptimizerParams(
        method="dogleg", max_iter=300, rel_thresh=1e-9, abs_thresh=1e-9,
        reject_budget=100, delta_min=1e-12))
    ee = link_poses(arm.fk, res.traj.pose[n_steps]).trans[-1]
    print(f"Final Error = {float(res.error):.4f}  ({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")
    print(f"end-effector reached ({float(ee[0]):.4f}, {float(ee[1]):.4f}) vs goal "
          f"({goal_point[0]:.1f}, {goal_point[1]:.1f}); final configuration "
          f"{res.traj.pose[n_steps].cpu().numpy().round(3)}")


if __name__ == "__main__":
    main()

"""SE(2) mobile base + 2-link arm, factor graph assembled by hand.

Port of examples/mobile_arm2_factor_graph.py
(MobileArm2FactorGraphExample.m): the MobileMap1 world, SE(2) x R^2
(Pose2Vector) states, a hand-built graph of Pose2Vector priors, Lie GP
priors, planar mobile-arm obstacle factors and vehicle dynamics (sigma
0.001), optimized with Gauss-Newton. The base drives from (-1, 0, pi/2)
to (1, 0, pi/2). The JAX script's 20 steps (the reference takes 50).

Run: python examples_torch/mobile_arm2_factor_graph.py [--cpu]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch import FactorGraph, OptimizerParams  # noqa: E402
from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.planner import init_traj_straight_line  # noqa: E402
from gpmp2_tpu_torch.robots import generate_mobile_arm  # noqa: E402


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    # MobileMap1 world (MobileArm2FactorGraphExample.m:9-17)
    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)

    # settings (lines 25-47), 20 steps as the JAX script
    total_time, n_steps = 5.0, 20
    dt = total_time / n_steps
    marm = generate_mobile_arm("SimpleTwoLinksArm", device=dev)
    space = marm.space  # SE(2) x R^2, dim 5
    Qc = np.eye(5)
    cost_sigma, eps = 0.1, 0.1
    dynamics_sigma = 0.001

    # Pose2Vector storage: (x, y, theta, q1, q2)
    start = torch.tensor([-1.0, 0.0, np.pi / 2, 0.0, 0.0], device=dev)
    goal = torch.tensor([1.0, 0.0, np.pi / 2, 0.0, 0.0], device=dev)
    zero = torch.zeros(5, device=dev)

    g = FactorGraph(space, n_steps + 1)
    g.add_prior_pose(0, start, 1e-4)
    g.add_prior_vel(0, zero, 1e-4)
    g.add_prior_pose(n_steps, goal, 1e-4)
    g.add_prior_vel(n_steps, zero, 1e-4)
    for i in range(n_steps + 1):
        g.add_obstacle(i, marm, sdf, cost_sigma, eps)
        g.add_vehicle_dynamics(i, dynamics_sigma)
        if i > 0:
            g.add_gp_prior(i - 1, i, dt, Qc)

    init = init_traj_straight_line(space, start, goal, n_steps, total_time)
    print(f"Initial Error = {float(g.error(init)):.1f}")
    res = g.optimize(init, OptimizerParams(method="gaussnewton", max_iter=100, rel_thresh=1e-5))
    print(f"Final Error = {float(res.error):.4f}  ({int(res.iterations)} iterations, "
          f"converged={bool(res.converged)})")
    pose = res.traj.pose.cpu().numpy()
    for i in range(0, n_steps + 1, 4):
        p = pose[i]
        print(f"  x_{i}: base=({p[0]: .3f}, {p[1]: .3f}, {p[2]: .3f}) "
              f"conf=({p[3]: .3f}, {p[4]: .3f})")


if __name__ == "__main__":
    main()

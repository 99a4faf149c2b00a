"""Multi-chain planner graph on the 2D point robot.

Port of examples/multi_graph_point_robot.py (the reference toolbox's
multi_graph/graph_pointRobot.py): sample candidate trajectories from the
GP posterior, build a planner DAG with random inter-chain edges, optimize
every node jointly in one factor graph, then extract the best hybrid path
by Dijkstra over the optimized factor costs. The draw takes a
torch.Generator seeded 42 where the JAX script takes PRNGKey(42).

Run: python examples_torch/multi_graph_point_robot.py [--cpu]
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch import PointRobotFK, VectorSpace, make_robot_model  # noqa: E402
from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy  # noqa: E402
from gpmp2_tpu_torch.device import resolve_device  # noqa: E402
from gpmp2_tpu_torch.planner import (build_planner_graph, edge_costs,  # noqa: E402
                                     make_multigraph_problem, multigraph_error,
                                     optimize_multigraph, sample_initializations,
                                     shortest_path)


def main():
    dev = torch.device("cpu") if "--cpu" in sys.argv else resolve_device()
    # world + robot (graph_pointRobot.py:21-45)
    ds = generate_2d_dataset("MultiObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    robot = make_robot_model(PointRobotFK(), [(0, 1.5, (0.0, 0.0, 0.0))], device=dev)

    # settings (lines 30-67)
    total_time, n_steps = 10.0, 20
    dt = total_time / n_steps
    check_inter = 1  # int(total_check_step / total_time_step - 1)
    cost_sigma, eps = 0.5, 4.0
    start = torch.tensor([0.0, 0.0], device=dev)
    goal = torch.tensor([17.0, 14.0], device=dev)
    zero = torch.zeros(2, device=dev)
    avg_vel = (goal / n_steps) / dt

    # candidate chains from the GP posterior (get_initializations)
    chains = sample_initializations(VectorSpace(2), start, goal, n_steps, total_time,
                                    np.eye(2), n_chains=4,
                                    generator=torch.Generator(dev).manual_seed(42))

    # planner DAG with random inter-chain edges (dropout_prob = 0.5,
    # seed_val = 1; graph_pointRobot.py:72-74)
    pose0, vel0, edges = build_planner_graph(chains, avg_vel, connect_prob=0.5, seed=1)
    print(f"planner graph: {pose0.shape[0]} nodes, {edges.shape[0]} edges")

    prob = make_multigraph_problem(robot, sdf, edges, start, zero, goal, zero, dt=dt,
                                   Qc=np.eye(2), cost_sigma=cost_sigma, epsilon=eps,
                                   obs_check_inter=check_inter)
    pose0 = torch.as_tensor(pose0, dtype=torch.float32, device=dev)
    vel0 = torch.as_tensor(vel0, dtype=torch.float32, device=dev)

    print(f"Initial Error = {float(multigraph_error(prob, pose0, vel0)):.1f}")
    pose, vel, err, iters, _ = optimize_multigraph(prob, pose0, vel0)
    print(f"Final Error = {float(err):.1f}  ({int(iters)} accepted steps)")

    # best path through the optimized DAG (Planner.get_shortest_path)
    ec, nc = edge_costs(prob, pose, vel)
    path = shortest_path(prob.edges, ec, nc)
    pts = pose.cpu().numpy()[path]
    print(f"extracted path through {len(path)} nodes:")
    for i, p in enumerate(pts):
        print(f"  {i:2d}: ({p[0]:7.3f}, {p[1]:7.3f})")

    assert len(path) == n_steps + 1
    path_cost = float(nc.cpu().numpy()[path].sum())
    print(f"path obstacle cost: {path_cost:.4f}")
    print("ok")


if __name__ == "__main__":
    main()

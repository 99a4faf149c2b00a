"""The planner API (port of gpmp2_tpu/planner)."""

from .batch import (batch_traj_optimize, collision_cost_batch, make_problem,
                    optimizer_params_from_setting, plan_batch, set_workspace_prior)
from .factor_graph import FactorGraph
from .isam2 import ISAM2BatchSessions, ISAM2TrajOptimizer
from .multigraph import (MultiGraphProblem, build_planner_graph, edge_costs,
                         make_multigraph_problem, multigraph_error, optimize_multigraph,
                         sample_initializations, shortest_path)
from .problem import (Trajectory, TrajProblem, collision_cost, self_collision_cost, traj_error,
                      traj_linearize)
from .settings import TrajOptimizerSetting
from .traj_utils import init_traj_straight_line, interpolate_traj

__all__ = ["batch_traj_optimize", "plan_batch", "make_problem", "collision_cost_batch",
           "optimizer_params_from_setting", "set_workspace_prior", "Trajectory", "TrajProblem",
           "collision_cost", "self_collision_cost", "traj_error", "traj_linearize",
           "TrajOptimizerSetting", "init_traj_straight_line", "interpolate_traj",
           "FactorGraph", "ISAM2TrajOptimizer", "ISAM2BatchSessions", "MultiGraphProblem",
           "sample_initializations", "build_planner_graph", "make_multigraph_problem",
           "multigraph_error", "optimize_multigraph", "edge_costs", "shortest_path"]

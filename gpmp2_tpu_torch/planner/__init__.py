from .batch import (batch_traj_optimize, make_problem, optimizer_params_from_setting,
                    plan_batch, set_workspace_prior)
from .problem import (Trajectory, TrajProblem, collision_cost, self_collision_cost, traj_error,
                      traj_linearize)
from .settings import TrajOptimizerSetting
from .traj_utils import init_traj_straight_line

__all__ = ["batch_traj_optimize", "make_problem", "optimizer_params_from_setting",
           "plan_batch", "set_workspace_prior", "Trajectory", "TrajProblem",
           "collision_cost", "self_collision_cost", "traj_error", "traj_linearize",
           "TrajOptimizerSetting", "init_traj_straight_line"]

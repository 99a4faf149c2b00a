"""gpmp2_tpu_torch: the PyTorch / CUDA port of gpmp2_tpu for NVIDIA Hopper.

The JAX package `gpmp2_tpu` stays the reference; this package mirrors its
layout module for module and keeps its public names and argument layouts,
with an explicit leading batch dimension where JAX used vmap. The TPU
kernels of the planner's paths are hand-written CUDA kernels here (csrc/),
built at first use on a CUDA tensor (`_build.py`); on CPU tensors every
wrapper runs its plain PyTorch version. Entry points build on CUDA unless
given `device="cpu"` or CPU tensors.

Covered: the batched LM / Gauss-Newton / Dogleg planner for
vector-space robots (DH arms with `ArmFK`, the planar `PointRobotFK`),
the SE(2) mobile base (`Pose2MobileBaseFK`, the Lie GP prior, vehicle
dynamics) and the mobile manipulators on SE(2) x R^n states (one or two
arms, with or without a torso lift; the presets of `generate_mobile_arm`,
PR2 and Vector among them), 2D and 3D SDFs (corner-packed or raw, shared
or one world per problem; opt-in float16 or bfloat16 tables, the
corner-major planar table, and the hull and coarse screens), joint and velocity limits, the GP prior and
interpolated obstacle factors, self-collision, workspace priors and the
end-effector goal, the float64 give-up rescue, incremental replanning
(`ISAM2TrajOptimizer`, and `ISAM2BatchSessions` for a fleet of sessions
solved as one batch), the hand-built graphs (`FactorGraph` over a
support-state chain, the multi-chain planner graphs of
`planner/multigraph.py`), GP densification (`interpolate_traj`), the
vehicle-dynamics residuals, SE(3) trajectory states (`SE3Space`, the
Pose3 GP prior and interpolator), the arms' link velocities
(`arm_link_velocities`), file IO, timing, buffer interop and the
matplotlib helpers (`utils`, `utils.plot`), the Schur-partitioned and
trajectory-sharded long-horizon solves (`solver/partitioned.py`) and the
device mesh on torch.distributed (`parallel`: `make_mesh`,
`shard_problems`, `fleet_stats`).
"""

from . import (datasets, dynamics, geometry, gp, kinematics, obstacle, parallel,  # noqa: F401
               planner, robots, solver, utils)
from .datasets import (generate_2d_dataset, generate_3d_dataset,
                       planar_sdf_from_occupancy, sdf_from_occupancy)
from .geometry import Pose3, SE2Space, SE2VectorSpace, SE3Space, StateSpace, VectorSpace
from .kinematics import (ArmFK, PointRobotFK, Pose2Mobile2ArmsFK, Pose2MobileArmFK,
                         Pose2MobileBaseFK, Pose2MobileVetLin2ArmsFK, Pose2MobileVetLinArmFK,
                         RobotModel, arm_link_velocities, base_pose3, goal_factor_error,
                         hinge_limit_cost, joint_limit_error, make_robot_model,
                         sphere_centers_world, velocity_limit_error,
                         workspace_orientation_error, workspace_pose_error,
                         workspace_position_error)
from .obstacle import (PlanarSDF, SignedDistanceField, hinge_loss, obstacle_factor_error,
                       obstacle_planar_factor_error, planar_sdf_lookup, sdf_lookup,
                       self_collision_error)
from .ops.btsolve import batched_block_tridiag_solve
from .planner import (FactorGraph, ISAM2BatchSessions, ISAM2TrajOptimizer, Trajectory,
                      TrajOptimizerSetting, TrajProblem, batch_traj_optimize, collision_cost,
                      collision_cost_batch, init_traj_straight_line, interpolate_traj,
                      make_problem, plan_batch, set_workspace_prior)
from .robots import (ARM_PRESETS, MOBILE_PRESETS, generate_arm, generate_mobile_arm,
                     generate_mobile_base)
from .solver import OptimizerParams, OptResult, optimize_batch
from .utils import (Timer, buffer_to_trajectory, load_sdf, read_sdf_vol_file, save_sdf,
                    trajectory_to_buffer)

__all__ = [
    "generate_2d_dataset", "generate_3d_dataset", "planar_sdf_from_occupancy",
    "sdf_from_occupancy", "Pose3", "StateSpace", "VectorSpace", "SE2Space",
    "SE2VectorSpace", "SE3Space", "ArmFK", "PointRobotFK", "Pose2MobileBaseFK",
    "Pose2MobileArmFK", "Pose2Mobile2ArmsFK", "Pose2MobileVetLinArmFK",
    "Pose2MobileVetLin2ArmsFK", "RobotModel", "make_robot_model", "arm_link_velocities",
    "base_pose3", "sphere_centers_world", "goal_factor_error", "hinge_limit_cost",
    "joint_limit_error", "velocity_limit_error", "workspace_orientation_error",
    "workspace_pose_error", "workspace_position_error", "PlanarSDF", "SignedDistanceField",
    "hinge_loss", "obstacle_factor_error", "obstacle_planar_factor_error",
    "planar_sdf_lookup", "sdf_lookup", "self_collision_error", "batched_block_tridiag_solve",
    "FactorGraph", "ISAM2TrajOptimizer", "ISAM2BatchSessions", "Trajectory",
    "TrajOptimizerSetting",
    "TrajProblem", "batch_traj_optimize", "collision_cost", "collision_cost_batch",
    "init_traj_straight_line", "interpolate_traj", "make_problem", "plan_batch",
    "set_workspace_prior", "ARM_PRESETS", "MOBILE_PRESETS", "generate_arm",
    "generate_mobile_arm", "generate_mobile_base", "OptimizerParams", "OptResult",
    "optimize_batch", "Timer", "buffer_to_trajectory", "load_sdf", "read_sdf_vol_file",
    "save_sdf", "trajectory_to_buffer",
]

"""gpmp2_tpu_torch: the PyTorch / CUDA port of gpmp2_tpu for NVIDIA Hopper.

The JAX package `gpmp2_tpu` stays the reference; this package mirrors its
layout module for module and keeps its public names and argument layouts,
with an explicit leading batch dimension where JAX used vmap. The two TPU
kernels of the batched planner's main path are hand-written CUDA kernels
here (csrc/), built at first use on a CUDA tensor (`_build.py`); on CPU
tensors every wrapper runs its plain PyTorch version.

This slice covers the batched WAM 7-DOF LM planner of bench.py: arm FK
(`ArmFK`), 3D SDFs, the GP prior and interpolated obstacle factors, and
the Gauss-Newton / Levenberg-Marquardt optimizer.
"""

from .datasets import generate_3d_dataset, sdf_from_occupancy
from .kinematics.fk import ArmFK
from .kinematics.robot import RobotModel, make_robot_model
from .obstacle.sdf import SignedDistanceField
from .planner import (Trajectory, TrajOptimizerSetting, TrajProblem,
                      batch_traj_optimize, collision_cost, make_problem,
                      plan_batch)
from .robots import generate_arm
from .solver.optimize import OptimizerParams, OptResult

__all__ = [
    "generate_3d_dataset", "sdf_from_occupancy", "ArmFK", "RobotModel",
    "make_robot_model", "SignedDistanceField", "Trajectory",
    "TrajOptimizerSetting", "TrajProblem", "batch_traj_optimize",
    "collision_cost", "make_problem", "plan_batch", "generate_arm",
    "OptimizerParams", "OptResult",
]

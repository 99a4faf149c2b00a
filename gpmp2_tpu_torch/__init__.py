"""gpmp2_tpu_torch: the PyTorch / CUDA port of gpmp2_tpu for NVIDIA Hopper.

The JAX package `gpmp2_tpu` stays the reference; this package mirrors its
layout module for module and keeps its public names and argument layouts,
with an explicit leading batch dimension where JAX used vmap. The TPU
kernels of the planner's paths are hand-written CUDA kernels here (csrc/),
built at first use on a CUDA tensor (`_build.py`); on CPU tensors every
wrapper runs its plain PyTorch version. Entry points build on CUDA unless
given `device="cpu"` or CPU tensors.

Covered so far: the batched LM / Gauss-Newton / Dogleg planner for
vector-space robots (DH arms with `ArmFK`, the planar `PointRobotFK`),
the SE(2) mobile base (`Pose2MobileBaseFK`, the Lie GP prior, vehicle
dynamics) and the mobile manipulators on SE(2) x R^n states (one or two
arms, with or without a torso lift; the presets of `generate_mobile_arm`,
PR2 and Vector among them), 2D and 3D SDFs (corner-packed or raw, shared
or one world per problem), joint and velocity limits, the GP prior and
interpolated obstacle factors, self-collision, workspace priors and the
end-effector goal, and the float64 give-up rescue.
"""

from .datasets import (generate_2d_dataset, generate_3d_dataset,
                       planar_sdf_from_occupancy, sdf_from_occupancy)
from .kinematics.fk import (ArmFK, PointRobotFK, Pose2Mobile2ArmsFK, Pose2MobileArmFK,
                            Pose2MobileBaseFK, Pose2MobileVetLin2ArmsFK, Pose2MobileVetLinArmFK)
from .kinematics.robot import RobotModel, make_robot_model
from .obstacle.sdf import PlanarSDF, SignedDistanceField
from .planner import (Trajectory, TrajOptimizerSetting, TrajProblem,
                      batch_traj_optimize, collision_cost, make_problem,
                      plan_batch, set_workspace_prior)
from .robots import generate_arm, generate_mobile_arm, generate_mobile_base
from .solver.optimize import OptimizerParams, OptResult

__all__ = [
    "generate_2d_dataset", "generate_3d_dataset", "planar_sdf_from_occupancy",
    "sdf_from_occupancy", "ArmFK", "PointRobotFK", "Pose2MobileBaseFK",
    "Pose2MobileArmFK", "Pose2Mobile2ArmsFK", "Pose2MobileVetLinArmFK",
    "Pose2MobileVetLin2ArmsFK", "RobotModel",
    "make_robot_model", "PlanarSDF", "SignedDistanceField", "Trajectory",
    "TrajOptimizerSetting", "TrajProblem", "batch_traj_optimize",
    "collision_cost", "make_problem", "plan_batch", "set_workspace_prior",
    "generate_arm", "generate_mobile_arm", "generate_mobile_base",
    "OptimizerParams", "OptResult",
]

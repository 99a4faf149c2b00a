"""Vehicle dynamics residuals (port of gpmp2_tpu/dynamics/__init__.py).

The raw residuals of VehicleDynamics.h and its three factor wrappers
(VehicleDynamicsFactorPose2 / Pose2Vector / Vector), exported for custom
graphs; the planner's vehicle-dynamics factor
(`planner/problem.py::_dyn_residual`) and `FactorGraph.add_vehicle_dynamics`
compute theirs through these. Inputs carry any leading dimensions.
"""

from __future__ import annotations

import torch

__all__ = ["simple_2d_vehicle_dynamics_pose2", "simple_2d_vehicle_dynamics_vector3"]


def simple_2d_vehicle_dynamics_pose2(vel):
    """Nonholonomic 'no sideways sliding' cost for the SE(2) body-frame
    velocity [vx, vy, omega]: err = v_y (VehicleDynamics.h:19-27). Pose2 and
    Pose2Vector states alike (the Pose2Vector wrapper reads the first three
    velocity components)."""
    return vel[..., 1]


def simple_2d_vehicle_dynamics_vector3(conf, vel):
    """World-frame variant for vector states [x, y, theta, ...]:
    err = v_y cos(theta) - v_x sin(theta) (VehicleDynamics.h:31-40)."""
    th = conf[..., 2]
    return vel[..., 1] * torch.cos(th) - vel[..., 0] * torch.sin(th)

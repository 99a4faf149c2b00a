"""Build the port's objects from numpy arrays (the JAX objects' leaves).

A caller that holds gpmp2_tpu objects flattens them to numpy arrays and
passes them in, so both packages compute on identical inputs; nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.se3 import Pose3
from ..kinematics.fk import ArmFK
from ..kinematics.robot import RobotModel, check_sphere_table
from ..obstacle.sdf import SignedDistanceField
from ..planner.problem import TrajProblem

__all__ = ["robot_model_from_numpy", "sdf_from_numpy", "problem_from_numpy",
           "PROBLEM_ARRAYS"]

# the TrajProblem fields that problem_from_numpy takes as arrays
PROBLEM_ARRAYS = ("dt", "Qc", "start_pose", "start_vel", "end_pose", "end_vel",
                  "pose_prior_w", "vel_prior_w", "goal_pose_w", "goal_vel_w",
                  "obs_w", "eps", "taus")


def robot_model_from_numpy(a, alpha, d, theta_bias, base_rot, base_trans,
                           sphere_link_ids, sphere_radii, sphere_centers, *,
                           dtype=torch.float32, device=None) -> RobotModel:
    """RobotModel of a revolute DH arm from its DH table (a, alpha, d,
    theta_bias (dof,)), base pose (3, 3) / (3,) and sphere table (link ids
    (S,), radii (S,), centres (S, 3)), validated as make_robot_model does."""
    fk = ArmFK.create(np.array(a), np.array(alpha), np.array(d),
                      theta_bias=np.array(theta_bias),
                      base_pose=Pose3(np.array(base_rot), np.array(base_trans)),
                      dtype=dtype, device=device)
    ids = np.array(sphere_link_ids, np.int64)
    radii = np.array(sphere_radii, np.float64)
    check_sphere_table(fk, ids, radii, "robot_model_from_numpy")
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)  # noqa: E731
    return RobotModel(
        fk,
        torch.as_tensor(ids, device=device),
        f(radii),
        f(sphere_centers),
    )


def sdf_from_numpy(origin, cell_size, data, *, dtype=torch.float32,
                   device=None) -> SignedDistanceField:
    """SignedDistanceField from origin (3,), cell size () and (Z, Y, X) data."""
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)  # noqa: E731
    return SignedDistanceField(f(origin), f(cell_size), f(data))


def problem_from_numpy(robot: RobotModel, sdf: SignedDistanceField, N: int, *,
                       dtype=torch.float32, device=None, **arrays) -> TrajProblem:
    """TrajProblem from the port's robot and SDF, the number of intervals N,
    and every array named in PROBLEM_ARRAYS (start/end states (B, d))."""
    if set(arrays) != set(PROBLEM_ARRAYS):
        raise TypeError(
            f"problem_from_numpy: needs exactly {sorted(PROBLEM_ARRAYS)}, "
            f"got {sorted(arrays)}")
    f = lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)  # noqa: E731
    return TrajProblem(robot=robot.to(dtype=dtype, device=device),
                       sdf=sdf.to(dtype=dtype, device=device), N=int(N),
                       **{k: f(v) for k, v in arrays.items()})

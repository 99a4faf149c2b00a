"""Build the port's objects from numpy arrays (the JAX objects' leaves).

A caller that holds gpmp2_tpu objects flattens them to numpy arrays and
passes them in, so both packages compute on identical inputs; nothing
here imports JAX. Every function here puts its tensors on `device` (default:
CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.se3 import Pose3
from ..kinematics.fk import ArmFK, PointRobotFK, Pose2MobileBaseFK
from ..kinematics.robot import RobotModel, check_sphere_table
from ..obstacle.sdf import PlanarSDF, SignedDistanceField
from ..planner.problem import TrajProblem

__all__ = ["robot_model_from_numpy", "point_robot_from_numpy",
           "mobile_base_from_numpy", "sdf_from_numpy", "planar_sdf_from_numpy",
           "problem_from_numpy", "PROBLEM_ARRAYS"]

# the TrajProblem fields that problem_from_numpy takes as arrays
PROBLEM_ARRAYS = ("dt", "Qc", "start_pose", "start_vel", "end_pose", "end_vel",
                  "pose_prior_w", "vel_prior_w", "goal_pose_w", "goal_vel_w",
                  "obs_w", "eps", "taus", "pos_lim_down", "pos_lim_up",
                  "pos_lim_thresh", "pos_lim_w", "vel_lim", "vel_lim_thresh",
                  "vel_lim_w", "dyn_w")


def _converter(dtype, device):
    """array -> tensor of `dtype` on `device` (default: CUDA)."""
    device = resolve_device(device)
    return lambda x: torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _robot(fk, sphere_link_ids, sphere_radii, sphere_centers, who, dtype, device):
    """RobotModel of `fk` and its sphere table, validated where it enters."""
    ids = np.array(sphere_link_ids, np.int64)
    radii = np.array(sphere_radii, np.float64)
    check_sphere_table(fk, ids, radii, who)
    f = _converter(dtype, device)
    return RobotModel(fk, torch.as_tensor(ids, device=resolve_device(device)),
                      f(radii), f(sphere_centers))


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
    return _robot(fk, sphere_link_ids, sphere_radii, sphere_centers,
                  "robot_model_from_numpy", dtype, device)


def point_robot_from_numpy(dof, sphere_link_ids, sphere_radii, sphere_centers, *,
                           dtype=torch.float32, device=None) -> RobotModel:
    """RobotModel of the planar point robot with `dof` dofs and its sphere
    table (link ids (S,), radii (S,), centres (S, 3))."""
    return _robot(PointRobotFK(int(dof)), sphere_link_ids, sphere_radii,
                  sphere_centers, "point_robot_from_numpy", dtype, device)


def mobile_base_from_numpy(sphere_link_ids, sphere_radii, sphere_centers, *,
                           dtype=torch.float32, device=None) -> RobotModel:
    """RobotModel of the SE(2) mobile base and its sphere table (link ids
    (S,), radii (S,), centres (S, 3))."""
    return _robot(Pose2MobileBaseFK(), sphere_link_ids, sphere_radii, sphere_centers,
                  "mobile_base_from_numpy", dtype, device)


def sdf_from_numpy(origin, cell_size, data, packed=None, *, dtype=torch.float32,
                   device=None) -> SignedDistanceField:
    """SignedDistanceField from origin (3,), cell size (), ([W,] Z, Y, X)
    data and, optionally, its packed table ([W,] cells, 8)."""
    f = _converter(dtype, device)
    return SignedDistanceField(f(origin), f(cell_size), f(data),
                               None if packed is None else f(packed))


def planar_sdf_from_numpy(origin, cell_size, data, packed=None, *,
                          dtype=torch.float32, device=None) -> PlanarSDF:
    """PlanarSDF from origin (2,), cell size (), ([W,] rows, cols) data and,
    optionally, its row-major packed table ([W,] cells, 4)."""
    f = _converter(dtype, device)
    return PlanarSDF(f(origin), f(cell_size), f(data),
                     None if packed is None else f(packed))


def problem_from_numpy(robot: RobotModel, sdf, N: int, *, flag_pos_limit=False,
                       flag_vel_limit=False, flag_vehicle_dynamics=False,
                       dtype=torch.float32, device=None, **arrays) -> TrajProblem:
    """TrajProblem from the port's robot and SDF, the number of intervals N,
    the limit and vehicle-dynamics flags, and every array named in
    PROBLEM_ARRAYS (start/end states (B, d))."""
    if set(arrays) != set(PROBLEM_ARRAYS):
        raise TypeError(
            f"problem_from_numpy: needs exactly {sorted(PROBLEM_ARRAYS)}, "
            f"got {sorted(arrays)}")
    device = resolve_device(device)
    f = _converter(dtype, device)
    return TrajProblem(robot=robot.to(dtype=dtype, device=device),
                       sdf=sdf.to(dtype=dtype, device=device), N=int(N),
                       flag_pos_limit=bool(flag_pos_limit),
                       flag_vel_limit=bool(flag_vel_limit),
                       flag_vehicle_dynamics=bool(flag_vehicle_dynamics),
                       **{k: f(v) for k, v in arrays.items()})

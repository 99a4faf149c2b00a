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
from ..kinematics.fk import (ArmFK, PointRobotFK, Pose2Mobile2ArmsFK, Pose2MobileArmFK,
                             Pose2MobileBaseFK, Pose2MobileVetLin2ArmsFK,
                             Pose2MobileVetLinArmFK)
from ..kinematics.robot import RobotModel, check_sphere_table
from ..obstacle.sdf import PlanarSDF, SignedDistanceField
from ..planner.problem import TrajProblem

__all__ = ["robot_model_from_numpy", "point_robot_from_numpy",
           "mobile_base_from_numpy", "mobile_arm_from_numpy", "sdf_from_numpy",
           "planar_sdf_from_numpy", "problem_from_numpy", "PROBLEM_ARRAYS"]

# the TrajProblem fields that problem_from_numpy takes as arrays
PROBLEM_ARRAYS = ("dt", "Qc", "start_pose", "start_vel", "end_pose", "end_vel",
                  "pose_prior_w", "vel_prior_w", "goal_pose_w", "goal_vel_w",
                  "obs_w", "eps", "taus", "pos_lim_down", "pos_lim_up",
                  "pos_lim_thresh", "pos_lim_w", "vel_lim", "vel_lim_thresh",
                  "vel_lim_w", "dyn_w", "goal_point", "goal_w", "sc_pairs_a",
                  "sc_pairs_b", "sc_eps", "sc_w", "ws_idx", "ws_link", "ws_rot",
                  "ws_point", "ws_pos_w", "ws_rot_w")
# ... of which these are integer indices
_INDEX_ARRAYS = ("sc_pairs_a", "sc_pairs_b", "ws_idx", "ws_link")


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


def mobile_arm_from_numpy(arms, sphere_link_ids, sphere_radii, sphere_centers, *,
                          base_T_arm=None, base_T_torso=None, torso_T_arm=None,
                          reverse_linact=False, dtype=torch.float32,
                          device=None) -> RobotModel:
    """RobotModel of a mobile manipulator on an SE(2) base and its sphere
    table (link ids (S,), radii (S,), centres (S, 3)). `arms`: the DH
    tables (a, alpha, d, theta_bias) of one or two arms. Each mount is a
    (rotation (3, 3), translation (3,)) pair, one per arm where a list:
    `base_T_arm` mounts the arms on the base (Pose2MobileArm,
    Pose2Mobile2Arms); `base_T_torso` with `torso_T_arm` puts a vertical
    linear actuator between them (Pose2MobileVetLinArm,
    Pose2MobileVetLin2Arms; `reverse_linact` flips its sign)."""
    device = resolve_device(device)
    f = _converter(dtype, device)

    def pose(p):
        return Pose3(f(p[0]), f(p[1]))

    chains = [ArmFK.create(*(np.array(x) for x in dh[:3]), theta_bias=np.array(dh[3]),
                           dtype=dtype, device=device) for dh in arms]
    if len(chains) not in (1, 2):
        raise ValueError(f"mobile_arm_from_numpy: one or two arms, got {len(chains)}")
    if base_T_torso is None:
        mounts = [pose(p) for p in (base_T_arm if len(chains) == 2 else [base_T_arm])]
        fk = (Pose2MobileArmFK.create(chains[0], mounts[0]) if len(chains) == 1
              else Pose2Mobile2ArmsFK.create(*chains, *mounts))
    else:
        mounts = [pose(p) for p in (torso_T_arm if len(chains) == 2 else [torso_T_arm])]
        fk = (Pose2MobileVetLinArmFK.create(chains[0], pose(base_T_torso), mounts[0],
                                            reverse_linact) if len(chains) == 1
              else Pose2MobileVetLin2ArmsFK.create(*chains, pose(base_T_torso), *mounts,
                                                   reverse_linact))
    return _robot(fk, sphere_link_ids, sphere_radii, sphere_centers,
                  "mobile_arm_from_numpy", dtype, device)


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
                       goal_region=False, dtype=torch.float32, device=None,
                       **arrays) -> TrajProblem:
    """TrajProblem from the port's robot and SDF, the number of intervals N,
    the limit, vehicle-dynamics and goal-region flags, and every array
    named in PROBLEM_ARRAYS (start/end states (B, d); a goal point (3,) is
    shared by the batch; the index arrays stay integer)."""
    if set(arrays) != set(PROBLEM_ARRAYS):
        raise TypeError(
            f"problem_from_numpy: needs exactly {sorted(PROBLEM_ARRAYS)}, "
            f"got {sorted(arrays)}")
    device = resolve_device(device)
    f = _converter(dtype, device)
    t = {k: torch.as_tensor(np.array(v), dtype=torch.int64, device=device)
         if k in _INDEX_ARRAYS else f(v) for k, v in arrays.items()}
    t["goal_point"] = t["goal_point"].expand(t["start_pose"].shape[0], 3).contiguous()
    return TrajProblem(robot=robot.to(dtype=dtype, device=device),
                       sdf=sdf.to(dtype=dtype, device=device), N=int(N),
                       flag_pos_limit=bool(flag_pos_limit),
                       flag_vel_limit=bool(flag_vel_limit),
                       flag_vehicle_dynamics=bool(flag_vehicle_dynamics),
                       goal_region=bool(goal_region), **t)

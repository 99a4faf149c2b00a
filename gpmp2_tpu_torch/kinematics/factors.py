"""Configuration-space factor residuals (port of gpmp2_tpu/kinematics/factors.py).

  - hinge / joint limit: JointLimitCost.h:16-32, JointLimitFactorVector.h:63-79,
    JointLimitFactorPose2Vector.h:66-91
  - velocity limit:      VelocityLimitFactorVector.h:62-78
  - end-effector goal:   GoalFactorArm.h:26-102
  - workspace priors:    GaussianPriorWorkspacePosition.h:53-69,
    GaussianPriorWorkspaceOrientation.h:53-71, GaussianPriorWorkspacePose.h:53-70

Configurations carry any leading dimensions.
"""

from __future__ import annotations

import torch

from ..geometry import so3
from ..geometry.statespace import StateSpace
from .fk import link_poses

__all__ = ["hinge_limit_cost", "limit_mask", "joint_limit_error",
           "velocity_limit_error", "goal_factor_error", "workspace_position_error",
           "workspace_orientation_error", "workspace_pose_error"]


def hinge_limit_cost(p, down, up, thresh):
    """Double-sided hinge with threshold (JointLimitCost.h:16-32): below
    down+thresh -> (down+thresh - p); inside -> 0; above up-thresh ->
    (p - up+thresh). Elementwise."""
    lo = down + thresh
    hi = up - thresh
    return torch.where(p < lo, lo - p, torch.where(p <= hi, torch.zeros_like(p), p - hi))


def limit_mask(space: StateSpace, dtype, device=None):
    """Joint-limit mask over the state dims: SE(2) x R^n states zero the
    three SE(2) dims (JointLimitFactorPose2Vector.h:66-91); ones elsewhere
    (the hinge runs on the storage coordinates, as in the JAX package)."""
    mask = torch.ones(space.dim, dtype=dtype, device=device)
    if space.kind == "se2_vector":
        mask[:3] = 0.0
    return mask


def joint_limit_error(space: StateSpace, conf, down, up, thresh):
    """Joint position limit residual (..., d) (JointLimitFactorVector.h:63-79)."""
    return limit_mask(space, conf.dtype, conf.device) * hinge_limit_cost(conf, down, up, thresh)


def velocity_limit_error(vel, vel_limit, thresh):
    """Symmetric velocity-limit residual (..., d): the hinge on
    (-v_max, +v_max) (VelocityLimitFactorVector.h:62-78)."""
    return hinge_limit_cost(vel, -vel_limit, vel_limit, thresh)


def _link_pose(fk, conf, link_id):
    """Rotation (..., 3, 3) and origin (..., 3) of link `link_id`: an int,
    or an integer tensor of the configurations' leading shape."""
    poses = link_poses(fk, conf)
    if isinstance(link_id, int):
        return poses.rot[..., link_id, :, :], poses.trans[..., link_id, :]
    # a one-hot sum: exact, and batched indices stay vmap-clean
    links = torch.arange(poses.trans.shape[-2], device=conf.device)
    pick = (link_id[..., None] == links).to(conf.dtype)
    return (torch.einsum("...l,...lij->...ij", pick, poses.rot),
            torch.einsum("...l,...li->...i", pick, poses.trans))


def goal_factor_error(fk, conf, goal_point, link_id=-1):
    """End-effector workspace goal residual (..., 3): the origin of link
    `link_id` (default: the last link) minus the goal (GoalFactorArm.h:58-77)."""
    return _link_pose(fk, conf, link_id)[1] - goal_point


def workspace_position_error(fk, conf, link_id, des_point):
    """Workspace position prior residual (..., 3)
    (GaussianPriorWorkspacePosition.h:53-69)."""
    return _link_pose(fk, conf, link_id)[1] - des_point


def workspace_orientation_error(fk, conf, link_id, des_rot):
    """Workspace orientation prior residual (..., 3): Log(R_des^T R_fk)
    (GaussianPriorWorkspaceOrientation.h:53-71)."""
    return so3.logmap(des_rot.mT @ _link_pose(fk, conf, link_id)[0])


def workspace_pose_error(fk, conf, link_id, des_rot, des_point):
    """Full workspace pose prior residual (..., 6) = [rot err, pos err]
    (GaussianPriorWorkspacePose.h:53-70)."""
    rot, trans = _link_pose(fk, conf, link_id)
    return torch.cat([so3.logmap(des_rot.mT @ rot), trans - des_point], dim=-1)

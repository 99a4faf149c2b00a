"""Sphere-based collision robot model (port of gpmp2_tpu/kinematics/robot.py).

An FK model plus body spheres (link id, radius, centre in the link frame),
as in RobotModel.h, for every FK family of kinematics/fk.py.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import se3
from ..geometry.se3 import Pose3
from ..geometry.statespace import StateSpace
from . import fk as fk_mod

__all__ = ["RobotModel", "make_robot_model", "check_sphere_table",
           "sphere_centers_world", "sphere_centers_and_jac", "points_and_jac"]


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """FK + body spheres."""

    fk: (fk_mod.ArmFK | fk_mod.PointRobotFK | fk_mod.Pose2MobileBaseFK
         | fk_mod.Pose2MobileArmFK | fk_mod.Pose2Mobile2ArmsFK
         | fk_mod.Pose2MobileVetLinArmFK | fk_mod.Pose2MobileVetLin2ArmsFK)
    sphere_link_ids: torch.Tensor  # (S,) int64
    sphere_radii: torch.Tensor  # (S,)
    sphere_centers: torch.Tensor  # (S, 3) in link frames

    @property
    def num_spheres(self) -> int:
        return self.sphere_radii.shape[-1]

    @property
    def dof(self) -> int:
        return fk_mod.dof_of(self.fk)

    @property
    def space(self) -> StateSpace:
        return fk_mod.state_space_of(self.fk)

    def to(self, dtype=None, device=None) -> "RobotModel":
        """Cast the float tables to `dtype` and move everything to `device`."""
        return RobotModel(
            self.fk.to(dtype=dtype, device=device),
            self.sphere_link_ids.to(device=device),
            self.sphere_radii.to(dtype=dtype, device=device),
            self.sphere_centers.to(dtype=dtype, device=device),
        )


def check_sphere_table(fk, ids: np.ndarray, radii: np.ndarray, who: str):
    """Raise unless every link id is in [0, n_links) and every radius is
    >= 0. The FK kernel indexes its frame array by link id unchecked."""
    n_links = fk_mod.num_links_of(fk)
    if ids.min() < 0 or ids.max() >= n_links:
        raise ValueError(
            f"{who}: sphere link ids must be in [0, {n_links}) "
            f"for this FK family, got range [{ids.min()}, {ids.max()}]"
        )
    if (radii < 0).any():
        raise ValueError(
            f"{who}: sphere radii must be >= 0, got {radii[radii < 0].tolist()}"
        )


def make_robot_model(fk, spheres: Sequence[Tuple[int, float, Tuple[float, float, float]]],
                     dtype=torch.float32, device=None) -> RobotModel:
    """Build a RobotModel from (link_id, radius, center_xyz) tuples
    (RobotModel.h:20-31), validating the table where it enters. The tables
    go to `device` (default: CUDA)."""
    device = resolve_device(device)
    if len(spheres) == 0:
        raise ValueError("make_robot_model: sphere table is empty")
    for i, s in enumerate(spheres):
        if len(s) != 3 or len(tuple(s[2])) != 3:
            raise ValueError(
                f"make_robot_model: sphere {i} must be (link_id, radius, "
                f"(x, y, z)), got {s!r}"
            )
    ids = np.asarray([s[0] for s in spheres], np.int64)
    radii = np.asarray([float(s[1]) for s in spheres])
    check_sphere_table(fk, ids, radii, "make_robot_model")
    centers = np.asarray([tuple(s[2]) for s in spheres], np.float64)
    return RobotModel(
        fk,
        torch.as_tensor(ids, device=device),
        torch.as_tensor(radii, dtype=dtype, device=device),
        torch.as_tensor(centers, dtype=dtype, device=device),
    )


def sphere_centers_world(model: RobotModel, q):
    """World positions of all body spheres: q (..., d) -> (..., S, 3)
    (RobotModel::sphereCenters, RobotModel-inl.h:12-40)."""
    poses = fk_mod.link_poses(model.fk, q)
    sphere_frames = Pose3(poses.rot[..., model.sphere_link_ids, :, :],
                          poses.trans[..., model.sphere_link_ids, :])
    return se3.transform_from(sphere_frames, model.sphere_centers)


def sphere_centers_and_jac(model: RobotModel, q):
    """Sphere centres (..., S, 3) and their position Jacobians (..., S, 3, d)
    wrt the configuration tangent (`points_and_jac` on the sphere table)."""
    return points_and_jac(model.fk, q, model.sphere_link_ids, model.sphere_centers)


def points_and_jac(fk, q, link_ids, local):
    """World positions (..., P, 3) of points fixed in links `link_ids` (P,)
    at link-frame coordinates `local` (P, 3), and their analytic Jacobians
    (..., P, 3, d) (gpmp2_tpu/kinematics/robot.py:105-162, 259-379):
      - the point robot: the constant [I2; 0] (PointRobot.cpp:15-50);
      - an SE(2) base, with the right-retraction tangent [vx, vy, omega]:
        dp/dvx = R_B e_x, dp/dvy = R_B e_y, dp/domega = e_z x (p - t_B);
      - a torso lift: +-e_z for points on the torso or above it
        (liftBasePose3, mobileBaseUtils.cpp:51-86);
      - a revolute joint j of an arm: z_j x (p - o_j) for points on link j
        of that arm or beyond (Arm.cpp:85-115 + RobotModel-inl.h:28-39), with
        z_j, o_j the axis and origin of the frame before it (the arm's base
        for j = 0), which on a mobile family is the re-rooted world frame
        (the analytic form of Pose2MobileArm.cpp:96-106's Adjoint)."""
    poses = fk_mod.link_poses(fk, q)
    frames = Pose3(poses.rot[..., link_ids, :, :], poses.trans[..., link_ids, :])
    points = se3.transform_from(frames, local)  # (..., P, 3)
    if isinstance(fk, fk_mod.PointRobotFK):
        J = torch.zeros(points.shape + (fk.dof,), dtype=q.dtype, device=q.device)
        J[..., 0, 0] = 1.0
        J[..., 1, 1] = 1.0
        return points, J
    cols = []
    if not isinstance(fk, fk_mod.ArmFK):
        c, s = torch.cos(q[..., 2]), torch.sin(q[..., 2])
        zero = torch.zeros_like(c)
        col_vx = torch.stack([c, s, zero], -1)[..., None, :].expand_as(points)
        col_vy = torch.stack([-s, c, zero], -1)[..., None, :].expand_as(points)
        rel_x = points[..., 0] - q[..., None, 0]
        rel_y = points[..., 1] - q[..., None, 1]
        col_w = torch.stack([-rel_y, rel_x, torch.zeros_like(rel_x)], -1)
        cols.append(torch.stack([col_vx, col_vy, col_w], -1))
        if isinstance(fk, fk_mod.Pose2MobileBaseFK):
            return points, cols[0]
    m = fk_mod.mounts(fk, q)
    if m.torso is not None:
        ez = torch.tensor([0.0, 0.0, m.lift_sign], dtype=q.dtype, device=q.device)
        col_lift = torch.where((link_ids >= 1)[:, None], ez, torch.zeros_like(ez))
        cols.append(col_lift.expand_as(points)[..., None])
    lead = q.shape[:-1]
    for mt in m.arms:
        A = mt.arm.dof
        # joint j turns about the z axis of the frame before it
        frame_rots = torch.cat([mt.base.rot.expand(lead + (3, 3))[..., None, :, :],
                                poses.rot[..., mt.link0:mt.link0 + A - 1, :, :]], dim=-3)
        frame_trans = torch.cat([mt.base.trans.expand(lead + (3,))[..., None, :],
                                 poses.trans[..., mt.link0:mt.link0 + A - 1, :]], dim=-2)
        z_axes = frame_rots[..., :, 2]  # (..., A, 3)
        rel = points[..., :, None, :] - frame_trans[..., None, :, :]  # (..., P, A, 3)
        crosses = torch.linalg.cross(z_axes[..., None, :, :].expand_as(rel), rel)
        on_arm = link_ids - mt.link0
        jmask = ((torch.arange(A, device=q.device)[None, :] <= on_arm[:, None])
                 & ((on_arm >= 0) & (on_arm < A))[:, None])  # (P, A)
        J = torch.where(jmask[..., None], crosses, torch.zeros_like(crosses))
        cols.append(J.transpose(-1, -2))
    return points, torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]

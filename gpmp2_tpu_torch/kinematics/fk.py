"""Forward kinematics of revolute DH arms (port of gpmp2_tpu/kinematics/fk.py).

DH convention (Arm.cpp:22-27, Spong eq. 3.10):
  H_j(theta) = Rz(theta_j + bias_j) * Tz(d_j) * Tx(a_j) * Rx(alpha_j)
  link_pose[j] = base * H_0 * ... * H_j

`ArmFK`, the planar `PointRobotFK` and the SE(2) `Pose2MobileBaseFK` are
ported; the mobile manipulators come with a later slice. Configurations
carry any leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..geometry import se3
from ..geometry.se3 import Pose3
from ..geometry.statespace import SE2Space, StateSpace, VectorSpace

__all__ = ["ArmFK", "PointRobotFK", "Pose2MobileBaseFK", "link_poses", "base_pose3",
           "state_space_of", "dof_of", "num_links_of"]


@dataclasses.dataclass(frozen=True)
class ArmFK:
    """DH-parameter revolute manipulator (reference Arm.h:27-146)."""

    a: torch.Tensor  # (dof,)
    alpha: torch.Tensor  # (dof,)
    d: torch.Tensor  # (dof,)
    theta_bias: torch.Tensor  # (dof,)
    base_rot: torch.Tensor  # (3, 3)
    base_trans: torch.Tensor  # (3,)

    @staticmethod
    def create(a, alpha, d, theta_bias=None, base_pose: Optional[Pose3] = None,
               dtype=torch.float32, device=None) -> "ArmFK":
        device = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        a = f(a)
        theta_bias = torch.zeros_like(a) if theta_bias is None else f(theta_bias)
        if base_pose is None:
            base_pose = se3.identity(dtype, device)
        return ArmFK(a, f(alpha), f(d), theta_bias, f(base_pose.rot),
                     f(base_pose.trans))

    @property
    def dof(self) -> int:
        return self.a.shape[-1]

    @property
    def base_pose(self) -> Pose3:
        return Pose3(self.base_rot, self.base_trans)

    def to(self, dtype=None, device=None) -> "ArmFK":
        return ArmFK(*(t.to(dtype=dtype, device=device)
                       for t in dataclasses.astuple(self)))


@dataclasses.dataclass(frozen=True)
class PointRobotFK:
    """Planar translating point robot (reference PointRobot.h:25-63): one
    link at (x, y, 0) with identity rotation; dofs past the second (e.g.
    PointRobot(3, 1)'s heading) do not move it."""

    dof: int = 2

    def to(self, dtype=None, device=None) -> "PointRobotFK":
        return self


@dataclasses.dataclass(frozen=True)
class Pose2MobileBaseFK:
    """SE(2) base only (reference Pose2MobileBase.h): 3 dof, one link at
    the base pose."""

    def to(self, dtype=None, device=None) -> "Pose2MobileBaseFK":
        return self


def _rot_z(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _rot_x(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([o, z, z], -1),
                        torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2)


def _dh_fixed_pose(fk: ArmFK, j: int) -> Pose3:
    """Theta-independent part of joint j's DH transform:
    Tz(d_j) * Tx(a_j) * Rx(alpha_j) (Arm.cpp:22-27)."""
    trans = torch.stack([fk.a[j], torch.zeros_like(fk.a[j]), fk.d[j]])
    return Pose3(_rot_x(fk.alpha[j]), trans)


def base_pose3(pose2) -> Pose3:
    """Lift Pose2 [x, y, theta] (..., 3) into Pose3 (mobileBaseUtils.cpp:18-31)."""
    trans = torch.stack([pose2[..., 0], pose2[..., 1], torch.zeros_like(pose2[..., 0])], -1)
    return Pose3(_rot_z(pose2[..., 2]), trans)


def link_poses(fk, q) -> Pose3:
    """World link poses for configurations q (..., dof):
    rot (..., links, 3, 3), trans (..., links, 3)."""
    if isinstance(fk, PointRobotFK):
        # PointRobot.cpp:15-50
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        trans = torch.stack([q[..., 0], q[..., 1], torch.zeros_like(q[..., 0])], -1)
        return Pose3(eye.expand(q.shape[:-1] + (1, 3, 3)), trans[..., None, :])
    if isinstance(fk, Pose2MobileBaseFK):
        b = base_pose3(q)
        return Pose3(b.rot[..., None, :, :], b.trans[..., None, :])
    if not isinstance(fk, ArmFK):
        raise NotImplementedError(f"FK family {type(fk).__name__} is a later slice")
    rots, transs = [], []
    cur = fk.base_pose
    for j in range(fk.dof):
        rz = _rot_z(q[..., j] + fk.theta_bias[j])
        m = _dh_fixed_pose(fk, j)
        hj = Pose3(rz @ m.rot, (rz @ m.trans[..., None])[..., 0])
        cur = se3.compose(cur, hj)
        rots.append(cur.rot)
        transs.append(cur.trans)
    return Pose3(torch.stack(rots, dim=-3), torch.stack(transs, dim=-2))


def dof_of(fk) -> int:
    if isinstance(fk, (ArmFK, PointRobotFK)):
        return fk.dof
    if isinstance(fk, Pose2MobileBaseFK):
        return 3
    raise NotImplementedError(f"FK family {type(fk).__name__} is a later slice")


def num_links_of(fk) -> int:
    return 1 if isinstance(fk, (PointRobotFK, Pose2MobileBaseFK)) else dof_of(fk)


def state_space_of(fk) -> StateSpace:
    """The configuration space of a robot family (its 'Pose' type)."""
    if isinstance(fk, Pose2MobileBaseFK):
        return SE2Space()
    return VectorSpace(dof_of(fk))

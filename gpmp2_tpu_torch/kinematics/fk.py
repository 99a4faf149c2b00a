"""Forward kinematics of every robot family (port of gpmp2_tpu/kinematics/fk.py).

DH convention (Arm.cpp:22-27, Spong eq. 3.10):
  H_j(theta) = Rz(theta_j + bias_j) * Tz(d_j) * Tx(a_j) * Rx(alpha_j)
  link_pose[j] = base * H_0 * ... * H_j

Families: the revolute DH arm `ArmFK`, the planar `PointRobotFK`, the
SE(2) base `Pose2MobileBaseFK`, and the mobile manipulators on an SE(2)
base: one arm (`Pose2MobileArmFK`), two arms (`Pose2Mobile2ArmsFK`), a
vertical linear actuator (torso lift) and one arm
(`Pose2MobileVetLinArmFK`) or two (`Pose2MobileVetLin2ArmsFK`). Every arm
runs through one DH chain (`_arm_chain`) rooted at its base frame, which
on a mobile family follows the vehicle (and the torso). Configurations
carry any leading batch dimensions; a mobile configuration is stored
[x, y, theta, (lift,) arm joints (, second arm's joints)].
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..geometry import se3
from ..geometry.se3 import Pose3
from ..geometry.statespace import SE2Space, SE2VectorSpace, StateSpace, VectorSpace

__all__ = ["ArmFK", "PointRobotFK", "Pose2MobileBaseFK", "Pose2MobileArmFK",
           "Pose2Mobile2ArmsFK", "Pose2MobileVetLinArmFK", "Pose2MobileVetLin2ArmsFK",
           "MOBILE_ARM_FAMILIES", "link_poses", "base_pose3", "state_space_of",
           "dof_of", "num_links_of"]


def _to(obj, dtype, device):
    """The dataclass `obj` with every tensor field cast and moved and every
    nested FK converted."""
    return dataclasses.replace(obj, **{
        f.name: v.to(dtype=dtype, device=device) for f in dataclasses.fields(obj)
        if hasattr(v := getattr(obj, f.name), "to") and not isinstance(v, bool)})


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
        return _to(self, dtype, device)


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


@dataclasses.dataclass(frozen=True)
class Pose2MobileArmFK:
    """SE(2) base + arm (reference Pose2MobileArm.cpp:28-108): links
    [base, arm links]; dof = 3 + arm dof."""

    arm: ArmFK
    base_T_arm_rot: torch.Tensor  # (3, 3)
    base_T_arm_trans: torch.Tensor  # (3,)

    @staticmethod
    def create(arm: ArmFK, base_T_arm: Optional[Pose3] = None) -> "Pose2MobileArmFK":
        if base_T_arm is None:
            base_T_arm = se3.identity(arm.a.dtype, arm.a.device)
        return Pose2MobileArmFK(arm, base_T_arm.rot, base_T_arm.trans)

    def to(self, dtype=None, device=None) -> "Pose2MobileArmFK":
        return _to(self, dtype, device)


@dataclasses.dataclass(frozen=True)
class Pose2Mobile2ArmsFK:
    """SE(2) base + two arms (reference Pose2Mobile2Arms.cpp): links
    [base, arm 1 links, arm 2 links]; dof = 3 + both arms' dofs."""

    arm1: ArmFK
    arm2: ArmFK
    base_T_arm1_rot: torch.Tensor
    base_T_arm1_trans: torch.Tensor
    base_T_arm2_rot: torch.Tensor
    base_T_arm2_trans: torch.Tensor

    @staticmethod
    def create(arm1, arm2, base_T_arm1: Pose3, base_T_arm2: Pose3) -> "Pose2Mobile2ArmsFK":
        return Pose2Mobile2ArmsFK(arm1, arm2, base_T_arm1.rot, base_T_arm1.trans,
                                  base_T_arm2.rot, base_T_arm2.trans)

    def to(self, dtype=None, device=None) -> "Pose2Mobile2ArmsFK":
        return _to(self, dtype, device)


@dataclasses.dataclass(frozen=True)
class Pose2MobileVetLinArmFK:
    """SE(2) base + vertical linear actuator (torso) + arm (reference
    Pose2MobileVetLinArm.cpp:20-98): links [base, torso, arm links];
    configuration [x, y, theta, lift, arm joints]; dof = 4 + arm dof."""

    arm: ArmFK
    base_T_torso_rot: torch.Tensor
    base_T_torso_trans: torch.Tensor
    torso_T_arm_rot: torch.Tensor
    torso_T_arm_trans: torch.Tensor
    reverse_linact: bool = False

    @staticmethod
    def create(arm, base_T_torso: Pose3, torso_T_arm: Pose3,
               reverse_linact=False) -> "Pose2MobileVetLinArmFK":
        return Pose2MobileVetLinArmFK(arm, base_T_torso.rot, base_T_torso.trans,
                                      torso_T_arm.rot, torso_T_arm.trans,
                                      bool(reverse_linact))

    def to(self, dtype=None, device=None) -> "Pose2MobileVetLinArmFK":
        return _to(self, dtype, device)


@dataclasses.dataclass(frozen=True)
class Pose2MobileVetLin2ArmsFK:
    """SE(2) base + torso + two arms (reference Pose2MobileVetLin2Arms.cpp):
    links [base, torso, arm 1 links, arm 2 links]; configuration
    [x, y, theta, lift, arm 1 joints, arm 2 joints]."""

    arm1: ArmFK
    arm2: ArmFK
    base_T_torso_rot: torch.Tensor
    base_T_torso_trans: torch.Tensor
    torso_T_arm1_rot: torch.Tensor
    torso_T_arm1_trans: torch.Tensor
    torso_T_arm2_rot: torch.Tensor
    torso_T_arm2_trans: torch.Tensor
    reverse_linact: bool = False

    @staticmethod
    def create(arm1, arm2, base_T_torso: Pose3, torso_T_arm1: Pose3,
               torso_T_arm2: Pose3, reverse_linact=False) -> "Pose2MobileVetLin2ArmsFK":
        return Pose2MobileVetLin2ArmsFK(
            arm1, arm2, base_T_torso.rot, base_T_torso.trans, torso_T_arm1.rot,
            torso_T_arm1.trans, torso_T_arm2.rot, torso_T_arm2.trans,
            bool(reverse_linact))

    def to(self, dtype=None, device=None) -> "Pose2MobileVetLin2ArmsFK":
        return _to(self, dtype, device)


MOBILE_ARM_FAMILIES = (Pose2MobileArmFK, Pose2Mobile2ArmsFK, Pose2MobileVetLinArmFK,
                       Pose2MobileVetLin2ArmsFK)


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


def _arm_chain(fk: ArmFK, q, base: Pose3) -> Pose3:
    """Link poses (..., dof, 3, 3) / (..., dof, 3) of the arm `fk` at joint
    angles q (..., dof), rooted at `base` (which may carry the same leading
    dimensions)."""
    rots, transs = [], []
    cur = base
    for j in range(fk.dof):
        rz = _rot_z(q[..., j] + fk.theta_bias[j])
        m = _dh_fixed_pose(fk, j)
        hj = Pose3(rz @ m.rot, (rz @ m.trans[..., None])[..., 0])
        cur = se3.compose(cur, hj)
        rots.append(cur.rot)
        transs.append(cur.trans)
    return Pose3(torch.stack(rots, dim=-3), torch.stack(transs, dim=-2))


def base_pose3(pose2) -> Pose3:
    """Lift Pose2 [x, y, theta] (..., 3) into Pose3 (mobileBaseUtils.cpp:18-31)."""
    trans = torch.stack([pose2[..., 0], pose2[..., 1], torch.zeros_like(pose2[..., 0])], -1)
    return Pose3(_rot_z(pose2[..., 2]), trans)


class ArmMount(NamedTuple):
    """One arm of a robot: its chain, its base frame (..., 3, 3) / (..., 3),
    the index of its first link among the robot's links, and the index of
    its first joint in the configuration (= tangent) vector."""

    arm: ArmFK
    base: Pose3
    link0: int
    col0: int


class Mounts(NamedTuple):
    """The frames of a robot family at configurations q: the vehicle (None
    for a fixed arm), the torso (None without a lift), the lift's sign,
    and the arms."""

    vehicle: Optional[Pose3]
    torso: Optional[Pose3]
    lift_sign: float
    arms: tuple


def mounts(fk, q) -> Mounts:
    """Where each arm of `fk` is rooted at configurations q (..., dof):
    the arm's base is vehicle * base_T_arm, or torso * torso_T_arm with
    torso = lift * (vehicle * base_T_torso) (liftBasePose3,
    mobileBaseUtils.cpp:51-86)."""
    if isinstance(fk, ArmFK):
        return Mounts(None, None, 1.0, (ArmMount(fk, fk.base_pose, 0, 0),))
    veh = base_pose3(q[..., :3])
    if isinstance(fk, Pose2MobileArmFK):
        base = se3.compose(veh, Pose3(fk.base_T_arm_rot, fk.base_T_arm_trans))
        return Mounts(veh, None, 1.0, (ArmMount(fk.arm, base, 1, 3),))
    if isinstance(fk, Pose2Mobile2ArmsFK):
        d1 = fk.arm1.dof
        b1 = se3.compose(veh, Pose3(fk.base_T_arm1_rot, fk.base_T_arm1_trans))
        b2 = se3.compose(veh, Pose3(fk.base_T_arm2_rot, fk.base_T_arm2_trans))
        return Mounts(veh, None, 1.0, (ArmMount(fk.arm1, b1, 1, 3),
                                       ArmMount(fk.arm2, b2, 1 + d1, 3 + d1)))
    if isinstance(fk, (Pose2MobileVetLinArmFK, Pose2MobileVetLin2ArmsFK)):
        sign = -1.0 if fk.reverse_linact else 1.0
        body = se3.compose(veh, Pose3(fk.base_T_torso_rot, fk.base_T_torso_trans))
        lift = sign * q[..., 3]
        # Pose3(I, (0, 0, lift)) * body
        torso = Pose3(body.rot, body.trans + torch.stack(
            [torch.zeros_like(lift), torch.zeros_like(lift), lift], -1))
        if isinstance(fk, Pose2MobileVetLinArmFK):
            base = se3.compose(torso, Pose3(fk.torso_T_arm_rot, fk.torso_T_arm_trans))
            return Mounts(veh, torso, sign, (ArmMount(fk.arm, base, 2, 4),))
        d1 = fk.arm1.dof
        b1 = se3.compose(torso, Pose3(fk.torso_T_arm1_rot, fk.torso_T_arm1_trans))
        b2 = se3.compose(torso, Pose3(fk.torso_T_arm2_rot, fk.torso_T_arm2_trans))
        return Mounts(veh, torso, sign, (ArmMount(fk.arm1, b1, 2, 4),
                                         ArmMount(fk.arm2, b2, 2 + d1, 4 + d1)))
    raise TypeError(f"unknown FK family {type(fk).__name__}")


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
    m = mounts(fk, q)
    frames = [p for p in (m.vehicle, m.torso) if p is not None]
    rots = [p.rot[..., None, :, :].expand(q.shape[:-1] + (1, 3, 3)) for p in frames]
    transs = [p.trans[..., None, :].expand(q.shape[:-1] + (1, 3)) for p in frames]
    for mt in m.arms:
        links = _arm_chain(mt.arm, q[..., mt.col0:mt.col0 + mt.arm.dof], mt.base)
        rots.append(links.rot)
        transs.append(links.trans)
    if len(rots) == 1:
        return Pose3(rots[0], transs[0])
    return Pose3(torch.cat(rots, dim=-3), torch.cat(transs, dim=-2))


def dof_of(fk) -> int:
    if isinstance(fk, (ArmFK, PointRobotFK)):
        return fk.dof
    if isinstance(fk, Pose2MobileBaseFK):
        return 3
    if isinstance(fk, Pose2MobileArmFK):
        return 3 + fk.arm.dof
    if isinstance(fk, Pose2Mobile2ArmsFK):
        return 3 + fk.arm1.dof + fk.arm2.dof
    if isinstance(fk, Pose2MobileVetLinArmFK):
        return 4 + fk.arm.dof
    if isinstance(fk, Pose2MobileVetLin2ArmsFK):
        return 4 + fk.arm1.dof + fk.arm2.dof
    raise TypeError(f"unknown FK family {type(fk).__name__}")


def num_links_of(fk) -> int:
    if isinstance(fk, (PointRobotFK, Pose2MobileBaseFK)):
        return 1
    if isinstance(fk, MOBILE_ARM_FAMILIES):
        # the base, (the torso,) then the arm links: x, y and theta move one
        # link, and a lift is one joint and one link
        return dof_of(fk) - 2
    return dof_of(fk)


def state_space_of(fk) -> StateSpace:
    """The configuration space of a robot family (its 'Pose' type)."""
    if isinstance(fk, (ArmFK, PointRobotFK)):
        return VectorSpace(dof_of(fk))
    if isinstance(fk, Pose2MobileBaseFK):
        return SE2Space()
    return SE2VectorSpace(dof_of(fk) - 3)

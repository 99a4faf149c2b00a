"""Mobile-robot model presets (port of gpmp2_tpu/robots/mobile_presets.py).

The plain SE(2) base, and the mobile manipulators of
generateMobileArm.m:20-244 (gpmp2_python/robots/generateMobileArm.py):
SimpleTwoLinksArm (mobile), SimpleTwoArms, 2DMobileArm2, Vector (omni base
+ JACO2) and PR2 (base + torso lift + two 7-DOF arms). Sphere tables are
robot geometry data, rows of [link_id, x, y, z, radius].
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.se3 import Pose3
from ..kinematics.fk import (ArmFK, Pose2Mobile2ArmsFK, Pose2MobileArmFK, Pose2MobileBaseFK,
                             Pose2MobileVetLin2ArmsFK)
from ..kinematics.robot import RobotModel, make_robot_model
from .presets import _JACO2_SPHERES, _PR2_SPHERES, _spheres

__all__ = ["generate_mobile_base", "generate_mobile_arm", "MOBILE_PRESETS"]

_PI = np.pi

_SIMPLE_MOBILE_SPHERES = [
    [0, -0.1, 0.0, 0.0, 0.12], [0, 0.0, 0.0, 0.0, 0.12],
    [0, 0.1, 0.0, 0.0, 0.12],
    [1, -0.3, 0.0, 0.0, 0.05], [1, -0.2, 0.0, 0.0, 0.05],
    [1, -0.1, 0.0, 0.0, 0.05],
    [2, -0.3, 0.0, 0.0, 0.05], [2, -0.2, 0.0, 0.0, 0.05],
    [2, -0.1, 0.0, 0.0, 0.05], [2, 0.0, 0.0, 0.0, 0.05],
]

_TWO_ARMS_SPHERES = [
    [0, -0.2, 0.0, 0.0, 0.24], [0, 0.0, 0.0, 0.0, 0.24],
    [0, 0.2, 0.0, 0.0, 0.24],
    [1, -0.6, 0.0, 0.0, 0.1], [1, -0.4, 0.0, 0.0, 0.1],
    [1, -0.2, 0.0, 0.0, 0.1],
    [2, -0.6, 0.0, 0.0, 0.1], [2, -0.4, 0.0, 0.0, 0.1],
    [2, -0.2, 0.0, 0.0, 0.1], [2, 0.0, 0.0, 0.0, 0.1],
    [3, -0.6, 0.0, 0.0, 0.1], [3, -0.4, 0.0, 0.0, 0.1],
    [3, -0.2, 0.0, 0.0, 0.1],
    [4, -0.6, 0.0, 0.0, 0.1], [4, -0.4, 0.0, 0.0, 0.1],
    [4, -0.2, 0.0, 0.0, 0.1], [4, 0.0, 0.0, 0.0, 0.1],
]

_MOBILE_ARM2_SPHERES = [
    [0, 0.2, 0.0, 0.0, 0.35], [0, -0.2, 0.0, 0.0, 0.35],
    [1, -0.05, 0.0, 0.0, 0.1], [1, -0.25, 0.0, 0.0, 0.1],
    [1, -0.45, 0.0, 0.0, 0.1],
    [2, -0.05, 0.0, 0.0, 0.1], [2, -0.25, 0.0, 0.0, 0.1],
    [2, -0.45, 0.0, 0.0, 0.1], [2, -0.65, 0.0, 0.0, 0.1],
    [2, -0.85, 0.0, 0.0, 0.1],
]

_VECTOR_BASE_SPHERES = [
    [0, -0.01, 0, 0, 0.005],
    [0, -0.26, -0.01, 0.08, 0.08], [0, -0.26, 0.15, 0.08, 0.08],
    [0, -0.26, -0.17, 0.08, 0.08], [0, 0.24, -0.01, 0.08, 0.08],
    [0, 0.24, 0.15, 0.08, 0.08], [0, 0.24, -0.17, 0.08, 0.08],
    [0, 0.04, -0.01, 0.6, 0.18],
    [0, -0.2, -0.06, 0.45, 0.1], [0, -0.2, 0.04, 0.45, 0.1],
    [0, 0.16, -0.07, 0.41, 0.06], [0, 0.16, 0.05, 0.41, 0.06],
    [0, 0.16, -0.18, 0.41, 0.06], [0, 0.16, 0.16, 0.41, 0.06],
    [0, 0.33, -0.01, 0.29, 0.05],
    [0, -0.01, -0.24, 0.31, 0.05], [0, -0.12, -0.24, 0.31, 0.05],
    [0, -0.22, -0.24, 0.31, 0.05], [0, -0.32, -0.24, 0.31, 0.05],
    [0, 0.1, -0.24, 0.31, 0.05], [0, 0.2, -0.24, 0.31, 0.05],
    [0, 0.3, -0.24, 0.31, 0.05],
    [0, -0.01, 0.22, 0.31, 0.05], [0, -0.12, 0.22, 0.31, 0.05],
    [0, -0.22, 0.22, 0.31, 0.05], [0, -0.32, 0.22, 0.31, 0.05],
    [0, 0.1, 0.22, 0.31, 0.05], [0, 0.2, 0.22, 0.31, 0.05],
    [0, 0.3, 0.22, 0.31, 0.05],
    [0, -0.32, -0.01, 0.31, 0.05], [0, -0.32, 0.10, 0.31, 0.05],
    [0, -0.32, -0.13, 0.31, 0.05], [0, 0.32, -0.01, 0.31, 0.05],
    [0, 0.32, 0.10, 0.31, 0.05], [0, 0.32, -0.13, 0.31, 0.05],
    [0, 0.12, -0.01, 0.87, 0.1], [0, 0.14, -0.11, 0.78, 0.08],
    [0, 0.14, 0.09, 0.78, 0.08], [0, 0.19, -0.01, 1.07, 0.08],
    [0, 0.14, -0.11, 0.97, 0.08], [0, 0.14, 0.09, 0.97, 0.08],
    [0, 0.175, -0.01, 1.2, 0.05], [0, 0.175, -0.01, 1.3, 0.05],
    [0, 0.175, -0.01, 1.4, 0.05], [0, 0.175, -0.01, 1.5, 0.05],
    [0, 0.175, -0.01, 1.62, 0.07], [0, 0.27, -0.01, 1.5, 0.05],
    [0, 0.37, -0.01, 1.5, 0.05], [0, 0.37, -0.01, 1.6, 0.05],
    [0, 0.37, -0.01, 1.66, 0.045], [0, 0.37, -0.1, 1.66, 0.045],
    [0, 0.37, 0.08, 1.66, 0.045],
]

_PR2_BASE_SPHERES = [
    [0, 0.0, 0.0, 0.13, 0.17], [0, 0.23, 0.0, 0.13, 0.17],
    [0, -0.23, 0.0, 0.13, 0.17], [0, 0.23, 0.23, 0.13, 0.17],
    [0, 0.0, 0.23, 0.13, 0.17], [0, 0.0, -0.23, 0.13, 0.17],
    [0, 0.23, -0.23, 0.13, 0.17], [0, -0.23, -0.23, 0.13, 0.17],
    [0, -0.23, 0.23, 0.13, 0.17],
    [0, -0.27, 0.0, 0.38, 0.08], [0, -0.27, 0.16, 0.38, 0.08],
    [0, -0.27, -0.16, 0.38, 0.08], [0, -0.27, 0.0, 0.54, 0.08],
    [0, -0.27, 0.14, 0.54, 0.08], [0, -0.27, -0.14, 0.54, 0.08],
    [1, -0.11, 0.0, 0.1, 0.25], [1, -0.09, -0.12, -0.34, 0.2],
    [1, -0.09, 0.12, -0.34, 0.2], [1, -0.02, 0.0, 0.37, 0.17],
]

MOBILE_PRESETS = ("SimpleTwoLinksArm", "SimpleTwoArms", "2DMobileArm2", "Vector", "PR2")


def _shift(rows, offset):
    """The sphere rows with their link ids moved by `offset` (an arm's
    table placed after the base's and the torso's links)."""
    return [[r[0] + offset] + list(r[1:]) for r in rows]


def generate_mobile_base(dtype=torch.float32, device=None) -> RobotModel:
    """Plain SE(2) base with one body sphere of radius 0.35 at its origin
    (MobileBaseFactorGraphExample-style problems). The tables go to
    `device` (default: CUDA)."""
    return make_robot_model(Pose2MobileBaseFK(), [(0, 0.35, (0.0, 0.0, 0.0))],
                            dtype=dtype, device=device)


def generate_mobile_arm(name: str, base_T_arm: Pose3 = None, dtype=torch.float32,
                        device=None) -> RobotModel:
    """Build a mobile-manipulator RobotModel by preset name
    (generateMobileArm.m:20-244) on `device` (default: CUDA). `base_T_arm`
    mounts Vector's arm (default: at the base frame)."""
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    eye = torch.eye(3, dtype=dtype, device=device)
    identity = Pose3(eye, t([0.0, 0.0, 0.0]))

    def arm(a, alpha, d, theta_bias=None):
        return ArmFK.create(a, alpha, d, theta_bias=theta_bias, dtype=dtype, device=device)

    def rot_z(a):
        return t([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])

    if name == "SimpleTwoLinksArm":
        fk = Pose2MobileArmFK.create(arm([0.3, 0.3], [0.0, 0.0], [0.0, 0.0]), identity)
        spheres = _spheres(_SIMPLE_MOBILE_SPHERES)
    elif name == "SimpleTwoArms":
        a = arm([0.6, 0.6], [0.0, 0.0], [0.0, 0.0])
        fk = Pose2Mobile2ArmsFK.create(a, a, Pose3(rot_z(-_PI / 3), identity.trans),
                                       Pose3(rot_z(_PI / 3), identity.trans))
        spheres = _spheres(_TWO_ARMS_SPHERES)
    elif name == "2DMobileArm2":
        fk = Pose2MobileArmFK.create(arm([1.0, 1.0], [0.0, 0.0], [0.0, 0.0]), identity)
        spheres = _spheres(_MOBILE_ARM2_SPHERES)
    elif name == "Vector":
        jaco = arm([0, 0.41, 0, 0, 0, 0], [_PI / 2, _PI, _PI / 2, 1.0472, 1.0472, _PI],
                   [0.2755, 0, -0.0098, -0.2501, -0.0856, -0.2228])
        fk = Pose2MobileArmFK.create(jaco, identity if base_T_arm is None else Pose3(
            t(base_T_arm.rot), t(base_T_arm.trans)))
        spheres = _spheres(_VECTOR_BASE_SPHERES) + _spheres(_shift(_JACO2_SPHERES, 1))
    elif name == "PR2":
        a = arm([0.1, 0, 0, 0, 0, 0, 0], [-1.5708, 1.5708, -1.5708, 1.5708, -1.5708, 1.5708, 0],
                [0, 0, 0.4, 0, 0.321, 0, 0], theta_bias=[0, 1.5708, 0, 0, 0, 0, 0])
        fk = Pose2MobileVetLin2ArmsFK.create(
            a, a, Pose3(eye, t([-0.05, 0.0, 0.790675])), Pose3(eye, t([0.0, 0.188, 0.0])),
            Pose3(eye, t([0.0, -0.188, 0.0])), reverse_linact=False)
        # link layout: 0 base, 1 torso, 2-8 left arm, 9-15 right arm
        spheres = (_spheres(_PR2_BASE_SPHERES) + _spheres(_shift(_PR2_SPHERES, 2))
                   + _spheres(_shift(_PR2_SPHERES, 9)))
    else:
        raise NameError(f"No such mobile arm '{name}'; available: {MOBILE_PRESETS}")
    return make_robot_model(fk, spheres, dtype=dtype, device=device)

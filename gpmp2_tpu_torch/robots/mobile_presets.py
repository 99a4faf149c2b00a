"""Mobile-robot model presets (port of gpmp2_tpu/robots/mobile_presets.py).

Only the plain SE(2) base is ported; the mobile manipulators
(generateMobileArm.m:20-244) come with a later slice.
"""

from __future__ import annotations

import torch

from ..kinematics.fk import Pose2MobileBaseFK
from ..kinematics.robot import RobotModel, make_robot_model

__all__ = ["generate_mobile_base"]


def generate_mobile_base(dtype=torch.float32, device=None) -> RobotModel:
    """Plain SE(2) base with one body sphere of radius 0.35 at its origin
    (MobileBaseFactorGraphExample-style problems). The tables go to
    `device` (default: CUDA)."""
    return make_robot_model(Pose2MobileBaseFK(), [(0, 0.35, (0.0, 0.0, 0.0))],
                            dtype=dtype, device=device)

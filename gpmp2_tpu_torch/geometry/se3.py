"""SE(3) rigid transforms as (rotation matrix, translation) pairs of tensors.

Port of the parts of gpmp2_tpu/geometry/se3.py that the arm's base pose
and link chain use. Leading dimensions broadcast, so one call composes a
whole batch of poses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Pose3", "identity", "compose", "transform_from"]


class Pose3(NamedTuple):
    """Rigid transform: x_world = rot @ x_local + trans."""

    rot: torch.Tensor  # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)


def identity(dtype=torch.float32, device=None) -> Pose3:
    return Pose3(torch.eye(3, dtype=dtype, device=device),
                 torch.zeros(3, dtype=dtype, device=device))


def compose(a: Pose3, b: Pose3) -> Pose3:
    return Pose3(a.rot @ b.rot, (a.rot @ b.trans[..., None])[..., 0] + a.trans)


def transform_from(p: Pose3, point):
    """Map a point from the pose's local frame to the world frame."""
    return (p.rot @ point[..., None])[..., 0] + p.trans

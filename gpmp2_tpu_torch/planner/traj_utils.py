"""Trajectory initialization (port of gpmp2_tpu/planner/traj_utils.py).

init_traj_straight_line: chart-space lerp of poses with constant average
velocity (initArmTrajStraightLine, TrajUtils.cpp:25-50; on SE(2) and
SE(2) x R^n the chart of the start, initPose2TrajStraightLine and
initPose2VectorTrajStraightLine, TrajUtils.cpp:53-93).
"""

from __future__ import annotations

import torch

from ..geometry.statespace import StateSpace
from .problem import Trajectory

__all__ = ["init_traj_straight_line"]


def init_traj_straight_line(space: StateSpace, start, end, total_step: int,
                            total_time: float) -> Trajectory:
    """Straight line from start to end (..., d) with velocity
    local(start, end) / total_time at every state: pose and vel (..., n, d)."""
    n = total_step + 1
    alphas = torch.linspace(0.0, 1.0, n, dtype=start.dtype, device=start.device)
    tangent = space.local(start, end)
    poses = space.retract(start[..., None, :], alphas[:, None] * tangent[..., None, :])
    avg_vel = tangent / total_time
    vels = avg_vel[..., None, :].expand(poses.shape).contiguous()
    return Trajectory(poses, vels)

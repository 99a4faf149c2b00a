"""Trajectory initialization and GP densification (port of
gpmp2_tpu/planner/traj_utils.py).

- init_traj_straight_line: chart-space lerp of poses with constant average
  velocity (initArmTrajStraightLine, TrajUtils.cpp:25-50; on SE(2) and
  SE(2) x R^n the chart of the start, initPose2TrajStraightLine and
  initPose2VectorTrajStraightLine, TrajUtils.cpp:53-93);
- interpolate_traj: `inter_step` GP-interpolated states inserted in every
  interval (interpolateArmTraj, TrajUtils.cpp:96-158, and the Pose2 and
  Pose2Vector variants, :200-275).
"""

from __future__ import annotations

import torch

from ..geometry.statespace import StateSpace
from ..gp.interpolator import interp_coeffs, interpolate_state
from .problem import Trajectory

__all__ = ["init_traj_straight_line", "interpolate_traj"]


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


def interpolate_traj(space: StateSpace, traj: Trajectory, Qc, delta_t,
                     inter_step: int) -> Trajectory:
    """Densify: between each pair of support states insert `inter_step`
    GP-interpolated states at tau_j = j * delta_t / (inter_step + 1),
    keeping the support states. pose and vel (..., n, d) become
    (..., N (inter_step + 1) + 1, d), N = n - 1: each interval's support
    state, then its interpolants; then the last state."""
    pose, vel = traj
    num_int = inter_step + 1
    dtype, device = pose.dtype, pose.device
    Qc = torch.as_tensor(Qc, dtype=dtype, device=device)
    dt = torch.as_tensor(delta_t, dtype=dtype, device=device)
    taus = torch.arange(1, num_int, dtype=dtype, device=device) * dt / num_int
    ends = (pose[..., :-1, None, :], vel[..., :-1, None, :],
            pose[..., 1:, None, :], vel[..., 1:, None, :])
    ip, iv = interpolate_state(space, interp_coeffs(Qc, dt, taus), *ends)  # (..., N, T, d)

    def dense(support, inner):
        blocks = torch.cat([support[..., :-1, None, :], inner], dim=-2)
        flat = blocks.reshape(blocks.shape[:-3] + (-1, blocks.shape[-1]))
        return torch.cat([flat, support[..., -1:, :]], dim=-2)

    return Trajectory(dense(pose, ip), dense(vel, iv))

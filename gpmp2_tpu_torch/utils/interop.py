"""Flat-buffer trajectory interop (port of gpmp2_tpu/utils/interop.py;
reference gpmp2/utils/OpenRAVEutils.cpp).

The reference's OpenRAVE plugin converts gtsam Values to a caller-owned
flat double buffer of shape (2 (total_step + 1), dof), all configurations
then all velocities, clamping configurations to the joint limits on the
way out, and back (OpenRAVEutils.cpp:15-104). The same contract on host
numpy buffers, row-major:

    [ conf_0 ... conf_N | vel_0 ... vel_N ]   (2 (N + 1), dof)

Trajectories may hold tensors on any device or arrays.
"""

from __future__ import annotations

import numpy as np

from ..device import host_array

__all__ = ["trajectory_to_buffer", "buffer_to_trajectory"]


def _host64(x) -> np.ndarray:
    return np.asarray(host_array(x), dtype=np.float64)


def trajectory_to_buffer(traj, joint_lower_limit, joint_upper_limit):
    """Pack a trajectory (pose (n, d), vel (n, d)) into a host (2n, d)
    buffer, configurations clamped to the joint limits, velocities not
    (convertValuesOpenRavePointer, OpenRAVEutils.cpp:56-80). Raises
    ValueError when the limits' length differs from dof (the reference
    throws, OpenRAVEutils.cpp:60-63)."""
    conf, vel = _host64(traj[0]), _host64(traj[1])
    if conf.ndim != 2 or conf.shape != vel.shape:
        raise ValueError(f"expected matching (n, dof) pose/vel, got {conf.shape} vs {vel.shape}")
    dof = conf.shape[1]
    lo = _host64(joint_lower_limit).reshape(-1)
    hi = _host64(joint_upper_limit).reshape(-1)
    if lo.shape[0] != dof or hi.shape[0] != dof:
        raise ValueError(f"joint limit size {lo.shape[0]}/{hi.shape[0]} differs from dof {dof}")
    return np.concatenate([np.clip(conf, lo, hi), vel], axis=0)


def buffer_to_trajectory(buffer, dof):
    """Unpack a (2n, dof) (or flat 2n dof) buffer into numpy (conf (n, d),
    vel (n, d)) (convertOpenRavePointerValues, OpenRAVEutils.cpp:83-104);
    wrap them in a Trajectory of tensors as needed."""
    buf = _host64(buffer).reshape(-1, dof)
    if buf.shape[0] % 2 != 0:
        raise ValueError(f"buffer rows {buf.shape[0]} not an even 2*(N+1)")
    n = buf.shape[0] // 2
    return buf[:n].copy(), buf[n:].copy()

"""Joint and velocity limit residuals (port of gpmp2_tpu/kinematics/factors.py:39-66
for vector and SE(2) states).

  - hinge / joint limit: JointLimitCost.h:16-32, JointLimitFactorVector.h:63-79
  - velocity limit:      VelocityLimitFactorVector.h:62-78
"""

from __future__ import annotations

import torch

from ..geometry.statespace import StateSpace

__all__ = ["hinge_limit_cost", "limit_mask", "joint_limit_error",
           "velocity_limit_error"]


def hinge_limit_cost(p, down, up, thresh):
    """Double-sided hinge with threshold (JointLimitCost.h:16-32): below
    down+thresh -> (down+thresh - p); inside -> 0; above up-thresh ->
    (p - up+thresh). Elementwise."""
    lo = down + thresh
    hi = up - thresh
    return torch.where(p < lo, lo - p, torch.where(p <= hi, torch.zeros_like(p), p - hi))


def limit_mask(space: StateSpace, dtype, device=None):
    """Joint-limit mask over the state dims: all ones on the vector and
    SE(2) spaces (the hinge runs on the storage coordinates, as in the
    JAX package); the SE(2) x R^n mask comes with the mobile arms."""
    return torch.ones(space.dim, dtype=dtype, device=device)


def joint_limit_error(space: StateSpace, conf, down, up, thresh):
    """Joint position limit residual (..., d) (JointLimitFactorVector.h:63-79)."""
    return limit_mask(space, conf.dtype, conf.device) * hinge_limit_cost(conf, down, up, thresh)


def velocity_limit_error(vel, vel_limit, thresh):
    """Symmetric velocity-limit residual (..., d): the hinge on
    (-v_max, +v_max) (VelocityLimitFactorVector.h:62-78)."""
    return hinge_limit_cost(vel, -vel_limit, vel_limit, thresh)

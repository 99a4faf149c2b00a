"""Gaussian-process trajectory interpolation (port of gpmp2_tpu/gp/interpolator.py).

State at tau in [0, delta_t] between support states (x1, v1), (x2, v2):

  vector (GaussianProcessInterpolatorLinear.h:62-122):
      [x; v](tau) = Lambda(tau) [x1; v1] + Psi(tau) [x2; v2];
  Lie (GaussianProcessInterpolatorLie.h:64-146):
      r1 = [0; v1], r2 = [Log(x1^-1 x2); v2],
      x(tau) = x1 * Exp(Lambda[:d] r1 + Psi[:d] r2),
      v(tau) = Lambda[d:] r1 + Psi[d:] r2.

States and coefficients carry leading dimensions that broadcast. The
planner takes Jacobians through `interpolate_pose` with torch.func.jacfwd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.statespace import StateSpace
from .gputils import calc_lambda, calc_psi

__all__ = ["InterpCoeffs", "interp_coeffs", "interpolate_state",
           "interpolate_pose", "interpolate_velocity"]


class InterpCoeffs(NamedTuple):
    """Lambda/Psi for a (delta_t, tau) pair, or a stack over taus."""

    lam: torch.Tensor  # (..., 2d, 2d)
    psi: torch.Tensor  # (..., 2d, 2d)


def interp_coeffs(Qc, delta_t, tau) -> InterpCoeffs:
    """`tau` may be a tensor of taus: the coefficients stack in front."""
    return InterpCoeffs(calc_lambda(Qc, delta_t, tau), calc_psi(Qc, delta_t, tau))


def _mix(coeffs: InterpCoeffs, s1, s2):
    """Lambda s1 + Psi s2 over the last axis."""
    return (coeffs.lam @ s1[..., None])[..., 0] + (coeffs.psi @ s2[..., None])[..., 0]


def interpolate_state(space: StateSpace, coeffs: InterpCoeffs, x1, v1, x2, v2):
    """(pose, velocity) at tau, on a vector or a Lie space."""
    d = space.dim
    if space.is_vector:
        out = _mix(coeffs, torch.cat([x1, v1], dim=-1), torch.cat([x2, v2], dim=-1))
        return out[..., :d], out[..., d:]
    r1 = torch.cat([torch.zeros_like(v1), v1], dim=-1)
    r2 = torch.cat([space.local(x1, x2), v2], dim=-1)
    mixed = _mix(coeffs, r1, r2)
    return space.compose(x1, space.expmap(mixed[..., :d])), mixed[..., d:]


def interpolate_pose(space: StateSpace, coeffs: InterpCoeffs, x1, v1, x2, v2):
    return interpolate_state(space, coeffs, x1, v1, x2, v2)[0]


def interpolate_velocity(space: StateSpace, coeffs: InterpCoeffs, x1, v1, x2, v2):
    return interpolate_state(space, coeffs, x1, v1, x2, v2)[1]

"""Constant-velocity GP prior and interpolation (port of gpmp2_tpu/gp)."""

from .gputils import calc_lambda, calc_phi, calc_psi, calc_Q, calc_Q_inv
from .interpolator import (InterpCoeffs, interp_coeffs, interpolate_pose, interpolate_state,
                           interpolate_velocity)
from .prior import gp_prior_error, gp_prior_jacobians_linear

__all__ = ["calc_Q", "calc_Q_inv", "calc_phi", "calc_lambda", "calc_psi", "InterpCoeffs",
           "interp_coeffs", "interpolate_pose", "interpolate_velocity", "interpolate_state",
           "gp_prior_error", "gp_prior_jacobians_linear"]

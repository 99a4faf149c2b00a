"""Gaussian-process interpolation coefficients.

Port of gpmp2_tpu/gp/interpolator.py::interp_coeffs. For vector states the
interpolated state at tau is Lambda(tau) [x1; v1] + Psi(tau) [x2; v2]
(GaussianProcessInterpolatorLinear.h:62-122).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gputils import calc_lambda, calc_psi

__all__ = ["InterpCoeffs", "interp_coeffs"]


class InterpCoeffs(NamedTuple):
    """Lambda/Psi for a (delta_t, tau) pair, or a stack over taus."""

    lam: torch.Tensor  # (..., 2d, 2d)
    psi: torch.Tensor  # (..., 2d, 2d)


def interp_coeffs(Qc, delta_t, tau) -> InterpCoeffs:
    """`tau` may be a tensor of taus: the coefficients stack in front."""
    return InterpCoeffs(calc_lambda(Qc, delta_t, tau), calc_psi(Qc, delta_t, tau))

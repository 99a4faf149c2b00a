"""Constant-velocity GP (white-noise-on-acceleration LTI-SDE) matrices.

Port of gpmp2_tpu/gp/gputils.py (closed forms of GPutils.h:22-59):

  Phi(tau)    = [[I, tau I], [0, I]]
  Q(tau)      = [[tau^3/3 Qc, tau^2/2 Qc], [tau^2/2 Qc, tau Qc]]
  Q(tau)^-1   = [[12 tau^-3 Qc^-1, -6 tau^-2 Qc^-1], [-6 tau^-2 Qc^-1, 4 tau^-1 Qc^-1]]
  Lambda(tau) = Phi(tau) - Q(tau) Phi(dt-tau)^T Q(dt)^-1 Phi(dt)
  Psi(tau)    = Q(tau) Phi(dt-tau)^T Q(dt)^-1

Qc is a (d, d) covariance tensor. `tau` may be a Python float or a tensor
of any shape; the result then has that shape in front of its (2d, 2d).
"""

from __future__ import annotations

import torch

__all__ = ["calc_Q", "calc_Q_inv", "calc_phi", "calc_lambda", "calc_psi"]


def _block2(m00, m01, m10, m11):
    top = torch.cat([m00, m01], dim=-1)
    bot = torch.cat([m10, m11], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _tau(tau, like):
    return torch.as_tensor(tau, dtype=like.dtype, device=like.device)[..., None, None]


def calc_Q(Qc, tau):
    """Process noise covariance over an interval tau (GPutils.h:25-31)."""
    tau = _tau(tau, Qc)
    return _block2(
        (tau**3) / 3.0 * Qc, (tau**2) / 2.0 * Qc,
        (tau**2) / 2.0 * Qc, tau * Qc,
    )


def calc_Q_inv(Qc, tau):
    """Closed-form inverse of calc_Q (GPutils.h:34-40)."""
    tau = _tau(tau, Qc)
    Qc_inv = torch.linalg.inv(Qc)
    return _block2(
        12.0 * tau**-3.0 * Qc_inv, -6.0 * tau**-2.0 * Qc_inv,
        -6.0 * tau**-2.0 * Qc_inv, 4.0 / tau * Qc_inv,
    )


def calc_phi(dof: int, tau, dtype=torch.float32, device=None):
    """State transition matrix over tau (GPutils.h:43-47)."""
    eye = torch.eye(dof, dtype=dtype, device=device)
    tau = torch.as_tensor(tau, dtype=dtype, device=device)[..., None, None]
    tau_eye = tau * eye
    return _block2(eye.expand_as(tau_eye), tau_eye,
                   torch.zeros_like(tau_eye), eye.expand_as(tau_eye))


def calc_lambda(Qc, delta_t, tau):
    """Interpolation matrix Lambda(tau) (GPutils.h:50-55)."""
    d = Qc.shape[-1]
    return calc_phi(d, tau, Qc.dtype, Qc.device) - calc_psi(
        Qc, delta_t, tau) @ calc_phi(d, delta_t, Qc.dtype, Qc.device)


def calc_psi(Qc, delta_t, tau):
    """Interpolation matrix Psi(tau) (GPutils.h:58-62)."""
    d = Qc.shape[-1]
    dt = torch.as_tensor(delta_t, dtype=Qc.dtype, device=Qc.device)
    tau = torch.as_tensor(tau, dtype=Qc.dtype, device=Qc.device)
    return (
        calc_Q(Qc, tau)
        @ calc_phi(d, dt - tau, Qc.dtype, Qc.device).mT
        @ calc_Q_inv(Qc, dt)
    )

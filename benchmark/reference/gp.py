"""The constant-velocity Gaussian process prior (white noise on the
acceleration), per GPMP2 (Mukadam et al., IJRR 2018, eq. 9-12):

  Phi(t) = [[I, t I], [0, I]],
  Q(t)   = [[t^3/3 Qc, t^2/2 Qc], [t^2/2 Qc, t Qc]],
  Psi(tau)    = Q(tau) Phi(dt - tau)^T Q(dt)^-1,
  Lambda(tau) = Phi(tau) - Psi(tau) Phi(dt).

Computed in float64 with numpy; Q(dt)^-1 by a numerical inverse.
"""

import numpy as np


def phi(d, t):
    out = np.eye(2 * d)
    out[:d, d:] = t * np.eye(d)
    return out


def q(Qc, t):
    return np.block([[t**3 / 3 * Qc, t**2 / 2 * Qc], [t**2 / 2 * Qc, t * Qc]])


def q_inv(Qc, dt):
    return np.linalg.inv(q(np.asarray(Qc, np.float64), dt))


def interp(Qc, dt, tau):
    """(Lambda, Psi) at tau, each (2d, 2d)."""
    Qc = np.asarray(Qc, np.float64)
    d = Qc.shape[0]
    psi = q(Qc, tau) @ phi(d, dt - tau).T @ q_inv(Qc, dt)
    lam = phi(d, tau) - psi @ phi(d, dt)
    return lam, psi

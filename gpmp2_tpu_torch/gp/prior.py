"""Gauss-Markov GP prior factor residuals.

Port of gpmp2_tpu/gp/prior.py:
  - vector states (GaussianProcessPriorLinear.h):
        error = [x1 + dt v1 - x2, v1 - v2], with the constant Jacobians
        H1 = [[I, dt I], [0, I]], H2 = -I;
  - Lie states, SE(2) and SE(2) x R^n (GaussianProcessPriorLie.h:71-85):
        error = [Log(x1^-1 x2) - dt v1, v2 - v1].
The velocity-difference sign differs between the two, as in the
reference. Noise covariance Q(dt) for both. Inputs carry any leading
(batch, interval) dimensions.
"""

from __future__ import annotations

import torch

from ..geometry.statespace import StateSpace

__all__ = ["gp_prior_error", "gp_prior_jacobians_linear"]


def gp_prior_error(space: StateSpace, x1, v1, x2, v2, delta_t):
    """Unwhitened GP prior residual, shape (..., 2d)."""
    if space.is_vector:
        return torch.cat([x1 + delta_t * v1 - x2, v1 - v2], dim=-1)
    return torch.cat([space.local(x1, x2) - v1 * delta_t, v2 - v1], dim=-1)


def gp_prior_jacobians_linear(dof: int, delta_t, dtype=torch.float32,
                              device=None):
    """Constant Jacobians (H1, H2), each (2d, 2d), wrt z1=(x1,v1), z2=(x2,v2)
    (GaussianProcessPriorLinear.h:68-82)."""
    eye = torch.eye(dof, dtype=dtype, device=device)
    zero = torch.zeros((dof, dof), dtype=dtype, device=device)
    dt = torch.as_tensor(delta_t, dtype=dtype, device=device)
    H1 = torch.cat(
        [torch.cat([eye, dt * eye], dim=-1), torch.cat([zero, eye], dim=-1)],
        dim=-2,
    )
    H2 = -torch.eye(2 * dof, dtype=dtype, device=device)
    return H1, H2

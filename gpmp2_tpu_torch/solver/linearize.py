"""Gauss-Newton accumulation helpers (port of gpmp2_tpu/solver/linearize.py).

Residual groups -> block-tridiagonal normal equations:

  H_diag[i] += J_i^T W J_i,  H_off[i] += J_i^T W J_{i+1},
  b[i] -= J_i^T W r,         err += 0.5 r^T W r.

W are precisions: `diag` is a scalar or per-residual-dim tensor, `full`
an (R, R) matrix over the residual dimension (last axis of r). Tensors
are batch-first: the quadratic errors sum over every axis but the first
and return one value per problem.
"""

from __future__ import annotations

__all__ = [
    "quad_err_diag", "quad_err_full",
    "jtwj_diag", "jtwj_full",
    "jtwr_diag", "jtwr_full",
]


def quad_err_diag(W, r):
    """0.5 * sum W r^2 over all axes but the batch axis: (B, ...) -> (B,)."""
    return 0.5 * (W * r * r).reshape(r.shape[0], -1).sum(-1)


def quad_err_full(W, r):
    """0.5 * sum r^T W r over all axes but the batch axis."""
    Wr = (W @ r[..., None])[..., 0]
    return 0.5 * (r * Wr).reshape(r.shape[0], -1).sum(-1)


def jtwj_diag(JA, W, JB):
    """J_A^T diag(W) J_B; J: (..., R, m) -> (..., m, m)."""
    WJB = W[..., None] * JB if W.dim() > 0 else W * JB
    return JA.mT @ WJB


def jtwr_diag(J, W, r):
    """J^T diag(W) r; J: (..., R, m), r: (..., R) -> (..., m)."""
    return (J.mT @ (W * r)[..., None])[..., 0]


def jtwj_full(JA, W, JB):
    return JA.mT @ (W @ JB)


def jtwr_full(J, W, r):
    return (J.mT @ (W @ r[..., None]))[..., 0]

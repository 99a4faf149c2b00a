"""SO(3) operations on 3x3 rotation matrices (port of gpmp2_tpu/geometry/so3.py:33-124).

gtsam::Rot3 conventions: tangent vectors are rotation vectors (axis *
angle), retract(R, w) = R Exp(w), local(R1, R2) = Log(R1^T R2). Every
function takes tensors with any leading dimensions and has no in-place
writes or data-dependent branches, so it runs under torch.func.vmap and
jacfwd; the small-angle and near-pi branches are the JAX package's,
selected with `where` so that both branches stay finite.
"""

from __future__ import annotations

import math

import torch

__all__ = ["hat", "vee", "expmap", "logmap"]

_EPS = 1e-10


def hat(w):
    """Skew-symmetric matrix of 3-vectors: hat(w) @ v == cross(w, v)."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1)], -2)


def vee(W):
    """Inverse of hat: the 3-vector of a skew-symmetric matrix."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _clip(x, lo, hi):
    """min(max(x, lo), hi) with jnp.clip's derivative: half at a tie."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _sinc_cosc(theta2):
    """sin(t)/t and (1 - cos(t))/t^2 from t^2, with their series below
    t^2 < 1e-8 (a safe value in the untaken branch keeps both finite)."""
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    return sinc, cosc


def expmap(w):
    """Rodrigues' formula: the rotation of rotation vectors w (..., 3)."""
    W = hat(w)
    sinc, cosc = _sinc_cosc((w * w).sum(-1))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + sinc[..., None, None] * W + cosc[..., None, None] * (W @ W)


def logmap(R):
    """Rotation vector (..., 3) of rotation matrices (..., 3, 3), handling
    theta near 0 and near pi as gtsam::Rot3::Logmap does."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # antisymmetric part: axis * 2 sin(theta)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    cos_theta = _clip((tr - 1.0) / 2.0, -1.0, 1.0)
    # every branch keeps finite derivatives for every input, selected or
    # not: arccos'(+-1) and sqrt'(0) are infinite
    eps_clip = 1e-6 if R.dtype == torch.float32 else 1e-12
    near_id = cos_theta > 1.0 - 1e-6  # theta < ~1.4e-3
    theta = torch.acos(_clip(cos_theta, -1.0 + eps_clip, 1.0 - eps_clip))
    generic = (theta / (2.0 * torch.sin(theta)))[..., None] * v
    # small angle: theta^2 ~ |v|^2 / 4, smooth in R
    t2 = 0.25 * (v * v).sum(-1)
    small_w = (0.5 * (1.0 + t2 / 12.0))[..., None] * v
    w = torch.where(near_id[..., None], small_w, generic)
    # near pi, from the diagonal of S = (R + R^T) / 2 = I + (1 - cos)(a a^T - I)
    S = 0.5 * (R + R.mT)
    one_minus_cos = torch.maximum(1.0 - cos_theta, torch.full_like(cos_theta, _EPS))
    diag = _clip((torch.diagonal(S, dim1=-2, dim2=-1) - cos_theta[..., None])
                 / one_minus_cos[..., None], 0.0, 1.0)
    diag = torch.where(diag < _EPS, torch.full_like(diag, _EPS), diag)
    axis_abs = torch.sqrt(diag)
    pick = (torch.argmax(axis_abs, -1)[..., None]
            == torch.arange(3, device=R.device)).to(R.dtype)
    ak = (axis_abs * pick).sum(-1)
    ak_safe = torch.where(ak < _EPS, torch.full_like(ak, _EPS), ak)
    col = (S * pick[..., None, :]).sum(-1) / (one_minus_cos * ak_safe)[..., None]
    axis = torch.where(pick > 0, ak[..., None].expand_as(col), col)
    nrm = torch.sqrt((axis * axis).sum(-1))
    axis = axis / torch.where(nrm < _EPS, torch.full_like(nrm, _EPS), nrm)[..., None]
    # sin(theta) >= 0 on (0, pi]: align the axis with v
    sign = torch.where((axis * v).sum(-1) < 0.0, -torch.ones_like(nrm), torch.ones_like(nrm))
    near_pi_w = (theta * sign)[..., None] * axis
    return torch.where((theta > math.pi - 1e-4)[..., None], near_pi_w, w)

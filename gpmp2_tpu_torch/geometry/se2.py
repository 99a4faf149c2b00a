"""SE(2) planar rigid transforms stored as [x, y, theta] tensors.

Port of gpmp2_tpu/geometry/se2.py (gtsam::Pose2 conventions): the tangent
is ordered [vx, vy, omega], exp/log are the exact SE(2) exponential and
logarithm, and retract(X, xi) = X * Exp(xi). Every function takes tensors
with any leading dimensions (they broadcast) and is free of in-place
writes and data-dependent branches, so it runs under torch.func.vmap and
jacfwd.

Near omega = 0 the V(omega) terms take their series under
`where(small, series, sin(safe_w) / safe_w)`, with safe_w = 1 where small:
both branches stay finite, so forward-mode derivatives at omega = 0 exactly
(the Log of the identity at the straight-line init) are finite too.
"""

from __future__ import annotations

import torch

__all__ = ["identity", "theta_wrap", "compose", "inverse", "between", "expmap",
           "logmap", "retract", "local", "transform_from"]


def identity(dtype=torch.float32, device=None):
    return torch.zeros(3, dtype=dtype, device=device)


def theta_wrap(t):
    """Wrap an angle to (-pi, pi]."""
    return torch.atan2(torch.sin(t), torch.cos(t))


def compose(a, b):
    """a * b for [x, y, theta] poses."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + c * b[..., 0] - s * b[..., 1]
    y = a[..., 1] + s * b[..., 0] + c * b[..., 1]
    return torch.stack([x, y, theta_wrap(a[..., 2] + b[..., 2])], dim=-1)


def inverse(p):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return torch.stack([x, y, -p[..., 2]], dim=-1)


def between(a, b):
    return compose(inverse(a), b)


def _v_terms(w):
    """(sin w / w, (1 - cos w) / w), with the series below w^2 < 1e-10.

    The constants are tensors of w's dtype: under vmap(jacfwd) a Python
    float operand promotes a float32 tangent to float64."""
    c = lambda x: torch.full_like(w, x)  # noqa: E731
    w2 = w * w
    small = w2 < 1e-10
    safe_w = torch.where(small, c(1.0), w)
    a = torch.where(small, c(1.0) - w2 / c(6.0), torch.sin(safe_w) / safe_w)
    b = torch.where(small, w / c(2.0) - w * w2 / c(24.0),
                    (c(1.0) - torch.cos(safe_w)) / safe_w)
    return a, b


def expmap(xi):
    """SE(2) exponential; xi = [vx, vy, omega]."""
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    a, b = _v_terms(w)
    return torch.stack([a * vx - b * vy, b * vx + a * vy, w], dim=-1)


def logmap(p):
    """SE(2) logarithm, returns [vx, vy, omega]."""
    x, y, w = p[..., 0], p[..., 1], theta_wrap(p[..., 2])
    a, b = _v_terms(w)
    det = a * a + b * b
    # V^-1 = 1/det [[a, b], [-b, a]]
    return torch.stack([(a * x + b * y) / det, (-b * x + a * y) / det, w], dim=-1)


def retract(p, xi):
    return compose(p, expmap(xi))


def local(a, b):
    return logmap(between(a, b))


def transform_from(p, point):
    """Map a planar point from the pose's frame to the world frame."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = p[..., 0] + c * point[..., 0] - s * point[..., 1]
    y = p[..., 1] + s * point[..., 0] + c * point[..., 1]
    return torch.stack([x, y], dim=-1)

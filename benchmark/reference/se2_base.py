"""A planar mobile base on SE(2): pose [x, y, theta], body-frame velocity
[vx, vy, omega], spheres fixed to the base.

SE(2) after gtsam's Pose2: retract(p, xi) = p * Exp(xi), local(p, q) =
Log(p^-1 q); Exp(vx, vy, w) = (V(w) [vx, vy], w) with V(w) = [[sin w,
cos w - 1], [1 - cos w, sin w]] / w, and Log inverts it with
V(w)^-1 = [[c, w/2], [-w/2, c]], c = (w/2) cot(w/2). The Lie GP prior
and interpolation of Dong et al. (ICRA 2018), as gpmp2's
GaussianProcessPriorLie and GaussianProcessInterpolatorLie: the error
[Log(x1^-1 x2) - dt v1, v2 - v1], and x(tau) = x1 * Exp(Lambda[:d] [0;
v1] + Psi[:d] [Log(x1^-1 x2); v2]). The vehicle-dynamics cost is the
body-frame sideways velocity vy (gpmp2 VehicleDynamics.h).
"""

import torch

space = "se2"
_SMALL = 1e-6


def _sin_terms(w):
    """(sin w / w, (1 - cos w) / w) with their series near 0."""
    small = w.abs() < _SMALL
    ws = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1 - w * w / 6, torch.sin(ws) / ws)
    b = torch.where(small, w / 2 - w ** 3 / 24, (1 - torch.cos(ws)) / ws)
    return a, b


def _half_cot(w):
    """(w / 2) cot(w / 2) with its series near 0."""
    small = w.abs() < _SMALL
    ws = torch.where(small, torch.ones_like(w), w)
    return torch.where(small, 1 - w * w / 12, ws / 2 * torch.cos(ws / 2) / torch.sin(ws / 2))


def compose(p, r):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = p[..., 0] + c * r[..., 0] - s * r[..., 1]
    y = p[..., 1] + s * r[..., 0] + c * r[..., 1]
    th = p[..., 2] + r[..., 2]
    return torch.stack([x, y, torch.atan2(torch.sin(th), torch.cos(th))], -1)


def inverse(p):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    return torch.stack([-c * p[..., 0] - s * p[..., 1], s * p[..., 0] - c * p[..., 1],
                        -p[..., 2]], -1)


def exp(xi):
    a, b = _sin_terms(xi[..., 2])
    return torch.stack([a * xi[..., 0] - b * xi[..., 1], b * xi[..., 0] + a * xi[..., 1],
                        xi[..., 2]], -1)


def log(p):
    w = torch.atan2(torch.sin(p[..., 2]), torch.cos(p[..., 2]))
    c = _half_cot(w)
    return torch.stack([c * p[..., 0] + w / 2 * p[..., 1], -w / 2 * p[..., 0] + c * p[..., 1],
                        w], -1)


def retract(x, z):
    return compose(x, exp(z))


def local(x, y):
    return log(compose(inverse(x), y))


class Model:
    def __init__(self, robot, device, dtype=torch.float64):
        table = torch.as_tensor(robot["spheres"], dtype=dtype, device=device)
        self.offset = table[:, 1:4]
        self.radius = table[:, 4]

    def sphere_centers(self, pose):
        """World centres (..., S, 3) of the base's spheres at poses (..., 3)."""
        c, s = torch.cos(pose[..., 2, None]), torch.sin(pose[..., 2, None])
        ox, oy, oz = self.offset.unbind(-1)
        x = pose[..., 0, None] + c * ox - s * oy
        y = pose[..., 1, None] + s * ox + c * oy
        return torch.stack([x, y, oz.expand_as(x)], -1)


def gp_residual(x1, v1, x2, v2, dt):
    return torch.cat([local(x1, x2) - dt * v1, v2 - v1], -1)


def interpolate(lam, psi, x1, v1, x2, v2):
    """Poses at every tau: lam, psi (T, 2d, 2d); ends (..., d) -> (..., T, d)."""
    d = x1.shape[-1]
    r1 = torch.cat([torch.zeros_like(v1), v1], -1)
    r2 = torch.cat([local(x1, x2), v2], -1)
    xi = (torch.einsum("tde,...e->...td", lam[:, :d], r1)
          + torch.einsum("tde,...e->...td", psi[:, :d], r2))
    return compose(x1[..., None, :], exp(xi))


def dynamics_residual(pose, vel):
    return vel[..., 1]

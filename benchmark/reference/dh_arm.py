"""A revolute arm from its Denavit-Hartenberg table, on R^dof.

Link j's frame is base * H_0 ... H_j with H_j = Rz(q_j + bias_j) Tz(d_j)
Tx(a_j) Rx(alpha_j) (Spong, eq. 3.10; gpmp2 Arm.cpp); a sphere's centre
is its link frame applied to its offset. Homogeneous 4x4 matrices in
float64.
"""

import torch

space = "vector"


class Model:
    def __init__(self, robot, device, dtype=torch.float64):
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        self.a, self.alpha, self.d = f(robot["a"]), f(robot["alpha"]), f(robot["d"])
        self.bias = f(robot["theta_bias"])
        base = torch.eye(4, dtype=dtype, device=device)
        base[:3, :3] = f(robot["base_rot"])
        base[:3, 3] = f(robot["base_trans"])
        self.base = base
        table = f(robot["spheres"])  # rows [link, x, y, z, r]
        self.link = table[:, 0].long()
        self.offset = torch.cat([table[:, 1:4], torch.ones_like(table[:, :1])], -1)
        self.radius = table[:, 4]
        self.dof = self.a.shape[0]

    def _dh(self, q):
        """H_j for every joint: (..., dof, 4, 4)."""
        th = q + self.bias
        ct, st = torch.cos(th), torch.sin(th)
        ca, sa = torch.cos(self.alpha), torch.sin(self.alpha)
        ca, sa = ca.expand_as(th), sa.expand_as(th)
        zero, one = torch.zeros_like(th), torch.ones_like(th)
        a, d = self.a.expand_as(th), self.d.expand_as(th)
        rows = [
            torch.stack([ct, -st * ca, st * sa, a * ct], -1),
            torch.stack([st, ct * ca, -ct * sa, a * st], -1),
            torch.stack([zero, sa, ca, d], -1),
            torch.stack([zero, zero, zero, one], -1),
        ]
        return torch.stack(rows, -2)

    def sphere_centers(self, q):
        """World centres (..., S, 3) of the spheres at configurations
        (..., dof)."""
        H = self._dh(q)
        frames, T = [], self.base.expand(q.shape[:-1] + (4, 4))
        for j in range(self.dof):
            T = T @ H[..., j, :, :]
            frames.append(T)
        frames = torch.stack(frames, -3)[..., self.link, :, :]  # (..., S, 4, 4)
        return (frames @ self.offset[..., None])[..., :3, 0]


def retract(x, z):
    return x + z


def local(x, y):
    return y - x


def gp_residual(x1, v1, x2, v2, dt):
    """[x1 + dt v1 - x2, v1 - v2] (the linear GP prior's error)."""
    return torch.cat([x1 + dt * v1 - x2, v1 - v2], -1)


def interpolate(lam, psi, x1, v1, x2, v2):
    """Configurations at every tau: lam, psi (T, 2d, 2d); ends (..., d)
    -> (..., T, d)."""
    d = x1.shape[-1]
    s1 = torch.cat([x1, v1], -1)
    s2 = torch.cat([x2, v2], -1)
    return (torch.einsum("tde,...e->...td", lam[:, :d], s1)
            + torch.einsum("tde,...e->...td", psi[:, :d], s2))


def dynamics_residual(pose, vel):
    return None

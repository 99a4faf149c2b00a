"""The reference's judgement of plans: their cost, collision cost and
progress, recomputed in float64 from the benchmark's inputs.

A plan of the GPMP2 graph (BatchTrajOptimizer's recipe) has support
states z_i = (x_i, v_i), i = 0..N, and costs 0.5 r^T W r of:
- priors on x_0, v_0, x_N, v_N (sigma conf_prior_sigma, vel_prior_sigma;
  the start and goal velocities are zero);
- the GP prior on every interval, weight Q(dt)^-1;
- the hinge obstacle cost max(0, eps + r_s - d(c_s)) of every sphere s
  at every support state and at obs_check_inter GP-interpolated states
  of every interval (tau_j = j dt / (inter + 1)), weight 1/cost_sigma^2;
  a centre outside the grid costs nothing;
- where the configuration asks for it, the vehicle-dynamics cost at
  every support state, weight 1/dyn_sigma^2.
The collision cost is the sum of max(0, r_s - d(c_s)) over the spheres of
the support states (epsilon 0). A plan's progress is the cost of the
straight line from its start to its goal (the planner's init: constant
velocity, so its end-velocity priors read |goal - start| / T over
vel_prior_sigma) over the cost of the plan.
"""

import importlib
import sys

import numpy as np
import torch
from torch.func import vmap

from . import gp

# the collision-free verdict: a collision cost below this (bench.py's)
FREE_BELOW = 1e-4
# the solved verdict: a plan has moved off its straight-line init when its
# cost is below the init's by this factor (PERF.md gives the readings)
MIN_PROGRESS = 10.0


class Problem:
    """The graph of one configuration on `device`, in float64 unless
    `dtype` says otherwise (the control computes it in bfloat16)."""

    def __init__(self, config, field, device, dtype=torch.float64):
        self.kind = importlib.import_module(f"{__package__}.{config['robot']['kind']}")
        self.model = self.kind.Model(config["robot"], device, dtype)
        self.field = field
        s = config["setting"]
        extra = config.get("problem", {})
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        self.N = s["total_step"]
        self.d = s["dof"]
        self.dt = s["total_time"] / s["total_step"]
        self.T = s["total_time"]
        Qc = np.asarray(s["Qc"], np.float64)
        inter = s["obs_check_inter"]
        taus = [j * self.dt / (inter + 1) for j in range(1, inter + 1)]
        pairs = [gp.interp(Qc, self.dt, t) for t in taus]
        self.lam = f(np.stack([p[0] for p in pairs]))
        self.psi = f(np.stack([p[1] for p in pairs]))
        # whitening of the GP prior: Q^-1 = L L^T, r_w = L^T r
        self.gp_white = f(np.linalg.cholesky(gp.q_inv(Qc, self.dt)))
        # each residual is whitened by 1/sigma, the root of its precision
        self.w_pose = 1.0 / s["conf_prior_sigma"]
        self.w_vel = 1.0 / s["vel_prior_sigma"]
        self.w_obs = 1.0 / s["cost_sigma"]
        self.eps_total = s["epsilon"] + self.model.radius
        self.w_dyn = (1.0 / extra["dyn_sigma"] if extra.get("flag_vehicle_dynamics")
                      else None)

    def states(self, pose, vel, z):
        """Support states moved by the tangent z (n, 2d)."""
        d = self.d
        return self.kind.retract(pose, z[:, :d]), vel + z[:, d:]

    def hinge(self, centers, eps_total):
        dist, ok = self.field.lookup(centers)
        return torch.where(ok & (dist <= eps_total), eps_total - dist, torch.zeros_like(dist))

    def residuals(self, z, pose, vel, start, goal):
        """The whitened residuals (R,) of one plan at tangent z (n, 2d)."""
        x, v = self.states(pose, vel, z)
        k = self.kind
        parts = [self.w_pose * k.local(start, x[0]), self.w_vel * v[0],
                 self.w_pose * k.local(goal, x[-1]), self.w_vel * v[-1]]
        r_gp = k.gp_residual(x[:-1], v[:-1], x[1:], v[1:], self.dt)
        parts.append((r_gp @ self.gp_white).reshape(-1))
        inner = k.interpolate(self.lam, self.psi, x[:-1], v[:-1], x[1:], v[1:])
        confs = torch.cat([x, inner.reshape(-1, x.shape[-1])], 0)
        parts.append(self.w_obs * self.hinge(self.model.sphere_centers(confs),
                                             self.eps_total).reshape(-1))
        if self.w_dyn is not None:
            parts.append(self.w_dyn * k.dynamics_residual(x, v))
        return torch.cat([p.reshape(-1) for p in parts])

    def cost(self, pose, vel, start, goal):
        """(P,) costs of plans with support states pose, vel (P, n, d)."""
        z = torch.zeros((pose.shape[1], 2 * self.d), dtype=pose.dtype, device=pose.device)
        r = vmap(self.residuals, in_dims=(None, 0, 0, 0, 0))(z, pose, vel, start, goal)
        return 0.5 * (r * r).sum(-1)

    def collision_cost(self, pose):
        """(P,) collision costs of support poses (P, n, d)."""
        return self.hinge(self.model.sphere_centers(pose), self.model.radius).sum((-2, -1))

    def straight_line(self, start, goal):
        """The straight-line trajectories (P, n, d) pose and vel from start
        to goal (P, d): evenly spaced along the tangent, at its velocity."""
        alpha = torch.linspace(0, 1, self.N + 1, dtype=start.dtype, device=start.device)
        tangent = self.kind.local(start, goal)
        pose = self.kind.retract(start[:, None, :], alpha[:, None] * tangent[:, None, :])
        return pose, (tangent / self.T)[:, None, :].expand_as(pose)

    def judge(self, pose, vel, start, goal):
        """Per plan (P,): cost, collision cost and progress (the straight
        line's cost over the plan's), for support states pose, vel
        (P, n, d) and endpoints start, goal (P, d)."""
        cost = self.cost(pose, vel, start, goal)
        init = self.cost(*self.straight_line(start, goal), start, goal)
        return cost, self.collision_cost(pose), init / cost.clamp(min=1e-300)


def compare(cost, cc, progress, port):
    """The numbers compared, from the reference's per-plan cost, collision
    cost and progress (see Problem.judge) and the port's columns (`port`:
    error, converged, gave_up; all (P,) on the host):
    - cost_gap: the largest gap between the error the port reports for a
      plan and the reference's cost of the plan it returned, relative to
      that cost;
    - unsolved_share: the share of the plans that are not solved: the port
      gave up or did not converge, or the reference finds the plan
      colliding (collision cost FREE_BELOW or more) or not moved off its
      init (progress below MIN_PROGRESS).
    """
    cost, cc, progress = (t.detach().cpu().double().numpy() for t in (cost, cc, progress))
    err = np.asarray(port["error"], np.float64)
    conv = np.asarray(port["converged"], bool) & ~np.asarray(port["gave_up"], bool)
    gap = np.abs(err - cost) / np.maximum(cost, 1e-12)
    solved = conv & (cc < FREE_BELOW) & (progress >= MIN_PROGRESS)
    print(f"reference: least progress {progress.min()!r}, {int((~conv).sum())} of "
          f"{len(cost)} plans unconverged or given up, {int((cc >= FREE_BELOW).sum())} "
          f"colliding, {int((progress < MIN_PROGRESS).sum())} short of progress",
          file=sys.stderr, flush=True)
    return {"cost_gap": float(np.max(gap)), "unsolved_share": float(1.0 - solved.mean())}

"""Manual factor-graph assembly: the reference's NonlinearFactorGraph path.

Port of gpmp2_tpu/planner/factor_graph.py. The reference's examples push
factors (PriorFactorVector, GaussianProcessPriorLinear,
ObstaclePlanarSDFFactorArm, ...) onto a gtsam::NonlinearFactorGraph and
hand it to an optimizer (Arm2FactorGraphExample.m:76-148). `FactorGraph`
collects such factor records over a fixed chain of support states
(x_0..x_N, v_0..v_N) and compiles them into the block-tridiagonal normal
equations the planner builds, so a hand-built graph runs on the batched
GN / LM / Dogleg loop (solver/optimize.py) and kernel K1.

Structural contract, checked when a factor is added: a unary factor
touches one state, a binary factor the adjacent states (i, i+1); that
keeps H block-tridiagonal. Other topologies belong to planner/multigraph.py.

Factors are grouped by kernel key and evaluated as one batched call per
group, with their parameters (prior means, interpolation coefficients,
limits, precisions) stacked along a leading factor axis:

- the priors, the GP prior, the limits, vehicle dynamics, the goal, the
  workspace priors and custom factors are plain torch functions of single
  states; each group takes its Jacobian wrt the retraction tangent with
  torch.func.vmap(torch.func.jacfwd(...)), as the JAX package takes it
  with jax.jacfwd (gpmp2_tpu/planner/factor_graph.py:392-419);
- the obstacle groups (`add_obstacle`, `add_obstacle_gp`) are linearized
  analytically on the planner's path, never under torch.func: on CUDA
  tensors their residuals reach kernels K2 and K3, which launch on raw
  device pointers. Sphere centres and Jacobians come from
  `problem._spheres_and_jac` (K2 for an ArmFK, the closed forms
  otherwise), the hinge and -g . J from `problem._obs_res_and_jac` (K3);
  an interpolated factor chains through d conf / d [z_i; z_i+1], the
  constant [Lambda | Psi][:d] of its own tau on a vector space and
  `problem._interval_interp_jacobians` on the Lie spaces.

Contributions are scatter-added into (H_diag, H_off, b) with `index_add_`,
so two factors on one state both count (JAX's `.at[i].add`); each group's
terms are summed per state before they reach H, which keeps the entries of
magnitude 1e8 (the boundary priors' precision) rounded as the planner
rounds them. Precisions
and coefficients are computed on the host in float64 and cast to the
trajectory's dtype; the graph runs on the trajectory's device, with the
robot, field and FK tables cast there once per dtype and device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..device import host_array
from ..dynamics import simple_2d_vehicle_dynamics_pose2, simple_2d_vehicle_dynamics_vector3
from ..geometry.statespace import StateSpace
from ..gp.gputils import calc_lambda, calc_psi
from ..gp.interpolator import InterpCoeffs, interpolate_pose
from ..gp.prior import gp_prior_error
from ..kinematics.factors import (goal_factor_error, joint_limit_error, velocity_limit_error,
                                  workspace_orientation_error, workspace_pose_error,
                                  workspace_position_error)
from ..kinematics.robot import sphere_centers_world
from ..solver.optimize import OptimizerParams, OptResult, optimize_batch
from .batch import _retract_traj
from .problem import (Trajectory, _interval_interp_jacobians, _obs_err, _obs_res_and_jac,
                      _spheres_and_jac, _split_tangent)

__all__ = ["FactorGraph"]


@dataclasses.dataclass
class _Factor:
    """One factor record; factors with the same `group` key (and arity and
    precision shape) evaluate as one call of the shared `kernel`, their
    `params` leaves stacked along a new leading axis."""

    idx: Tuple[int, ...]  # (i,) unary or (i, i+1) binary
    W: np.ndarray  # (R,) diagonal or (R, R) full precision, float64
    name: str
    group: object  # hashable grouping key
    kernel: object  # _Residual or _Obstacle
    params: tuple  # host arrays (stacked within a group), or ()


def _np_Q_inv(Qc: np.ndarray, tau: float) -> np.ndarray:
    """Host-side float64 GP precision Q(tau)^-1 (GPutils.h:34-40)."""
    Qi = np.linalg.inv(Qc)
    return np.block([
        [12.0 * tau**-3.0 * Qi, -6.0 * tau**-2.0 * Qi],
        [-6.0 * tau**-2.0 * Qi, 4.0 / tau * Qi],
    ])


def _sigma_to_prec_diag(sigma, R: int) -> np.ndarray:
    """Isotropic or diagonal sigma -> precision diagonal of length R, in
    float64 on the host (cast to the trajectory's dtype at use)."""
    s = np.atleast_1d(np.asarray(host_array(sigma), np.float64))
    if s.shape[0] == 1:
        s = np.broadcast_to(s, (R,))
    if s.shape != (R,):
        raise ValueError(f"sigma must be scalar or length {R}, got {s.shape}")
    return 1.0 / s**2


class _Residual:
    """A factor kernel fn(params, p, v) or fn(params, p1, v1, p2, v2) of
    single states in plain torch, evaluated and differentiated through
    torch.func. `build(dtype, device)` returns fn with its constant
    operands (FK tables, dt) in the trajectory's dtype and device."""

    def __init__(self, build):
        self.build = build

    def bind(self, space, dtype, device):
        fn = self.build(dtype, device)

        def error(params, states):
            ax = None if params == () else 0
            return vmap(fn, in_dims=(ax,) + (0,) * len(states))(params, *states)

        def linearize(params, states):
            """(r (F, R), J (F, R, k m)) wrt the tangents of the k states."""
            ax = None if params == () else 0

            def one(z, pr, *st):
                def f(dz):
                    r = fn(pr, *_split_tangent(space, dz, *st))
                    return r, r
                return jacfwd(f, has_aux=True)(z)

            p = states[0]
            z = torch.zeros(space.dim * len(states), dtype=p.dtype, device=p.device)
            J, r = vmap(one, in_dims=(None, ax) + (0,) * len(states))(z, params, *states)
            return r, J

        return error, linearize


def _plain(fn):
    """A _Residual whose function has no constant operands to cast."""
    return _Residual(lambda dtype, device: fn)


class _Obstacle:
    """The obstacle factor of one (robot, field, eps), on a support state
    (unary) or at a GP-interpolated state between two (binary, params =
    the factor's own (Lambda, Psi)). Linearized analytically through the
    planner's sphere pass and lookup (K2, K3 on CUDA tensors)."""

    def __init__(self, robot, sdf, eps, interpolated):
        self.robot, self.sdf, self.eps, self.interpolated = robot, sdf, eps, interpolated

    def bind(self, space, dtype, device):
        robot = self.robot.to(dtype=dtype, device=device)
        sdf = self.sdf.to(dtype=dtype, device=device)
        eps = torch.as_tensor(self.eps, dtype=dtype, device=device)
        d = space.dim

        def confs(params, states):
            if not self.interpolated:
                return states[0]
            return interpolate_pose(space, InterpCoeffs(*params), *states)

        def error(params, states):
            return _obs_err(robot, sdf, eps, sphere_centers_world(robot, confs(params, states)))

        def linearize(params, states):
            q = confs(params, states)  # (F, d)
            r, Jq = _obs_res_and_jac(robot, sdf, eps, *_spheres_and_jac(robot, q))
            if not self.interpolated:  # (F, S, d) -> the pose block of (F, S, 2d)
                return r, torch.cat([Jq, torch.zeros_like(Jq)], dim=-1)
            lam, psi = params
            if space.is_vector:  # d conf / d [x1 v1 x2 v2] = [Lambda | Psi][:d]
                dconf = torch.cat([lam[:, :d, :], psi[:, :d, :]], dim=-1)
            else:
                dconf = _interval_interp_jacobians(
                    space, InterpCoeffs(lam[:, None], psi[:, None]), states, q[:, None])[:, 0]
            return r, Jq @ dconf  # (F, S, 4d)

        return error, linearize


@dataclasses.dataclass
class _Group:
    """A group compiled for one dtype and device: its states' indices, its
    stacked precisions and params, and its bound kernel."""

    unary: bool
    i0: torch.Tensor  # (F,) int64 first state index
    W: torch.Tensor  # (F, R) or (F, R, R)
    params: tuple  # stacked (F, ...) leaves, or ()
    error: Callable
    linearize: Callable

    def states(self, pose, vel):
        if self.unary:
            return pose[self.i0], vel[self.i0]
        i1 = self.i0 + 1
        return pose[self.i0], vel[self.i0], pose[i1], vel[i1]


def _stack_params(params_list, dtype, device):
    """Stack the factors' params leaf by leaf along a new leading axis,
    float leaves cast to the trajectory's dtype; () when every factor's
    params are ()."""
    if all(p == () for p in params_list):
        return ()

    def stack(*xs):
        a = np.stack([host_array(x) for x in xs])
        t = torch.as_tensor(a, device=device)
        return t.to(dtype) if t.is_floating_point() else t

    return tuple(stack(*leaves) for leaves in zip(*params_list))


def _quad(W, r):
    """0.5 sum of the group's weighted squared residuals."""
    if W.dim() == 2:
        return 0.5 * (W * r * r).sum()
    return 0.5 * torch.einsum("fr,frs,fs->", r, W, r)


class FactorGraph:
    """A hand-assembled factor graph over a support-state chain.

    Usage mirrors the reference examples: construct, `add_*` factors in any
    order, then `error(traj)` / `linearize(traj)` / `optimize(init)` with
    `traj` a Trajectory of pose (n, d) and vel (n, d) tensors; the graph
    computes on their device.
    """

    def __init__(self, space: StateSpace, num_states: int):
        if num_states < 1:
            raise ValueError("num_states must be >= 1")
        self.space = space
        self.n = num_states
        self.factors: List[_Factor] = []
        self._kernels = {}  # group key -> the kernel its factors share
        self._compiled = {}  # (dtype, device) -> (len(factors), [_Group])

    # -- structural checks -------------------------------------------------

    def _check_idx(self, *idx: int):
        for i in idx:
            if not (0 <= i < self.n):
                raise ValueError(f"state index {i} out of range [0, {self.n})")
        if len(idx) == 2 and idx[1] != idx[0] + 1:
            raise ValueError(
                f"binary factors must touch adjacent states (i, i+1) to "
                f"keep the normal equations block-tridiagonal; got {idx}. "
                f"Use planner.multigraph for arbitrary topologies.")

    def _add(self, idx, W, name, group, kernel, params=()):
        """Append a factor; factors added with the same key share the first
        one's kernel, which is what makes them one group."""
        kernel = self._kernels.setdefault(group, kernel)
        self.factors.append(_Factor(tuple(int(i) for i in idx), W, name, group, kernel,
                                    params))
        return self

    # -- the reference factor inventory ------------------------------------

    def add_prior_pose(self, i: int, mean, sigma):
        """PriorFactorVector / PriorFactorPose2 / ... on x_i (gtsam
        PriorFactor semantics: r = local(mean, x))."""
        self._check_idx(i)
        space = self.space
        return self._add((i,), _sigma_to_prec_diag(sigma, space.dim), "prior_pose",
                         ("prior_pose",), _plain(lambda pr, p, v: space.local(pr[0], p)),
                         (host_array(mean),))

    def add_prior_vel(self, i: int, mean, sigma):
        """PriorFactorVector on v_i."""
        self._check_idx(i)
        return self._add((i,), _sigma_to_prec_diag(sigma, self.space.dim), "prior_vel",
                         ("prior_vel",), _plain(lambda pr, p, v: v - pr[0]), (host_array(mean),))

    def add_gp_prior(self, i: int, j: int, delta_t, Qc):
        """GaussianProcessPriorLinear / -Lie between states i and j = i+1
        (gp/prior.py; GaussianProcessPriorLinear.h:57-83)."""
        self._check_idx(i, j)
        dt = float(delta_t)
        space = self.space

        def build(dtype, device):
            dt_t = torch.tensor(dt, dtype=dtype, device=device)
            return lambda _, p1, v1, p2, v2: gp_prior_error(space, p1, v1, p2, v2, dt_t)

        return self._add((i, j), _np_Q_inv(np.asarray(host_array(Qc), np.float64), dt), "gp_prior",
                         ("gp_prior", dt), _Residual(build))

    def _obstacle(self, robot, sdf, eps, interpolated: bool):
        eps = float(eps)
        name = "obstacle_gp" if interpolated else "obstacle"
        return (name, id(robot), id(sdf), eps), _Obstacle(robot, sdf, eps, interpolated)

    def add_obstacle(self, i: int, robot, sdf, cost_sigma, eps):
        """ObstacleSDFFactor / ObstaclePlanarSDFFactor on x_i
        (ObstacleSDFFactor-inl.h:18-60); 2D or 3D by the field's type."""
        self._check_idx(i)
        key, kernel = self._obstacle(robot, sdf, eps, False)
        return self._add((i,), _sigma_to_prec_diag(cost_sigma, robot.num_spheres),
                         "obstacle", key, kernel)

    def add_obstacle_gp(self, i: int, j: int, robot, sdf, cost_sigma, eps, Qc, delta_t, tau):
        """ObstacleSDFFactorGP / ObstaclePlanarSDFFactorGP between states i
        and j = i+1 at interpolation offset tau (ObstacleSDFFactorGP-inl.h:18-77)."""
        self._check_idx(i, j)
        key, kernel = self._obstacle(robot, sdf, eps, True)
        Qc64 = torch.as_tensor(host_array(Qc), dtype=torch.float64, device="cpu")
        co = (calc_lambda(Qc64, float(delta_t), float(tau)).numpy(),
              calc_psi(Qc64, float(delta_t), float(tau)).numpy())
        return self._add((i, j), _sigma_to_prec_diag(cost_sigma, robot.num_spheres),
                         "obstacle_gp", key, kernel, co)

    def add_vehicle_dynamics(self, i: int, sigma):
        """VehicleDynamicsFactorPose2 / -Pose2Vector / -Vector on (x_i, v_i)
        (VehicleDynamics.h:19-40): the body-frame v_y on SE(2) and
        SE(2) x R^n, v_y cos(theta) - v_x sin(theta) on a vector state
        [x, y, theta, ...]."""
        self._check_idx(i)
        space = self.space
        if space.is_vector and space.dim < 3:
            raise ValueError("vehicle dynamics on a vector state needs [x, y, theta, ...], "
                             f"got dim {space.dim}")
        if space.is_vector:
            dyn = lambda _, p, v: simple_2d_vehicle_dynamics_vector3(p, v)[None]  # noqa: E731
        else:
            dyn = lambda _, p, v: simple_2d_vehicle_dynamics_pose2(v)[None]  # noqa: E731
        return self._add((i,), _sigma_to_prec_diag(sigma, 1), "dynamics", ("dynamics",),
                         _plain(dyn))

    def add_joint_limit(self, i: int, down, up, thresh, sigma):
        """JointLimitFactorVector / -Pose2Vector on x_i
        (JointLimitFactorVector.h:63-79). The threshold is rounded to
        float32 at the state's storage width, as the JAX package stores it
        (storage and tangent widths are equal on every kind the port has)."""
        self._check_idx(i)
        space = self.space
        th = np.broadcast_to(np.asarray(host_array(thresh), np.float32), (space.dim,))
        return self._add((i,), _sigma_to_prec_diag(sigma, space.dim), "joint_limit",
                         ("joint_limit",),
                         _plain(lambda pr, p, v: joint_limit_error(space, p, *pr)),
                         (host_array(down), host_array(up), th))

    def add_velocity_limit(self, i: int, vel_limit, thresh, sigma):
        """VelocityLimitFactorVector on v_i (VelocityLimitFactorVector.h:62-78);
        the threshold rounded to float32 as in `add_joint_limit`."""
        self._check_idx(i)
        d = self.space.dim
        th = np.broadcast_to(np.asarray(host_array(thresh), np.float32), (d,))
        return self._add((i,), _sigma_to_prec_diag(sigma, d), "vel_limit", ("vel_limit",),
                         _plain(lambda pr, p, v: velocity_limit_error(v, *pr)),
                         (host_array(vel_limit), th))

    def _fk_factor(self, i, fk, link_id, name, R, sigma, residual, params):
        """A factor of link `link_id`'s frame through `fk` (cast to the
        trajectory's dtype and device when the graph compiles)."""
        self._check_idx(i)

        def build(dtype, device):
            fk_c = fk.to(dtype=dtype, device=device)
            return lambda pr, p, v: residual(fk_c, p, pr)

        return self._add((i,), _sigma_to_prec_diag(sigma, R), name, (name, id(fk), link_id),
                         _Residual(build), params)

    def add_goal(self, i: int, fk, goal_point, sigma, link_id: int = -1):
        """GoalFactorArm on x_i: end-effector position - goal
        (GoalFactorArm.h:58-77)."""
        return self._fk_factor(i, fk, link_id, "goal", 3, sigma,
                               lambda f, p, pr: goal_factor_error(f, p, pr[0], link_id),
                               (host_array(goal_point),))

    def add_workspace_position(self, i: int, fk, link_id, des_point, sigma):
        """GaussianPriorWorkspacePositionArm on x_i."""
        return self._fk_factor(i, fk, link_id, "ws_position", 3, sigma,
                               lambda f, p, pr: workspace_position_error(f, p, link_id, pr[0]),
                               (host_array(des_point),))

    def add_workspace_orientation(self, i: int, fk, link_id, des_rot, sigma):
        """GaussianPriorWorkspaceOrientationArm on x_i."""
        return self._fk_factor(
            i, fk, link_id, "ws_orientation", 3, sigma,
            lambda f, p, pr: workspace_orientation_error(f, p, link_id, pr[0]),
            (host_array(des_rot),))

    def add_workspace_pose(self, i: int, fk, link_id, des_rot, des_point, sigma):
        """GaussianPriorWorkspacePoseArm on x_i."""
        return self._fk_factor(
            i, fk, link_id, "ws_pose", 6, sigma,
            lambda f, p, pr: workspace_pose_error(f, p, link_id, pr[0], pr[1]),
            (host_array(des_rot), host_array(des_point)))

    def add_custom(self, idx: Sequence[int], res: Callable, sigma_or_W, residual_dim: int,
                   name: str = "custom"):
        """Any user residual: unary `res(pose_i, vel_i)` or adjacent-binary
        `res(p1, v1, p2, v2)` of single states, returning a (residual_dim,)
        tensor; it is differentiated with torch.func. Each custom factor is
        its own group."""
        if len(idx) not in (1, 2):
            raise ValueError(
                f"add_custom supports unary (i,) or adjacent-binary "
                f"(i, i+1) factors; got {len(idx)} indices {tuple(idx)}. "
                f"Use planner.multigraph for arbitrary topologies.")
        self._check_idx(*idx)
        W = np.asarray(host_array(sigma_or_W), np.float64)
        if W.ndim < 2:
            W = _sigma_to_prec_diag(sigma_or_W, residual_dim)
        return self._add(tuple(idx), W, name, object(), _plain(lambda _, *states: res(*states)))

    # -- evaluation --------------------------------------------------------

    def _groups(self):
        """Factors grouped by (group key, arity, W shape), in the order of
        each group's first factor."""
        groups = {}
        for f in self.factors:
            groups.setdefault((f.group, len(f.idx), f.W.shape, f.W.ndim), []).append(f)
        return list(groups.values())

    def _compile(self, dtype, device) -> List[_Group]:
        """The groups with their operands in `dtype` on `device`, built once
        per dtype and device (again after factors are added)."""
        hit = self._compiled.get((dtype, device))
        if hit is not None and hit[0] == len(self.factors):
            return hit[1]
        out = []
        for fs in self._groups():
            error, linearize = fs[0].kernel.bind(self.space, dtype, device)
            out.append(_Group(
                unary=len(fs[0].idx) == 1,
                i0=torch.as_tensor([f.idx[0] for f in fs], dtype=torch.int64, device=device),
                W=torch.as_tensor(np.stack([f.W for f in fs]), dtype=dtype, device=device),
                params=_stack_params([f.params for f in fs], dtype, device),
                error=error, linearize=linearize))
        self._compiled[(dtype, device)] = (len(self.factors), out)
        return out

    def _check_traj(self, traj: Trajectory):
        pose, vel = traj
        if pose.dim() != 2 or pose.shape[0] != self.n or vel.shape != (self.n, self.space.dim):
            raise ValueError(f"expected pose and vel of {self.n} states of dim "
                             f"{self.space.dim}, got {tuple(pose.shape)} and "
                             f"{tuple(vel.shape)}")
        return pose, vel

    def error(self, traj: Trajectory):
        """Total graph error 0.5 * sum of weighted squared residuals
        (gtsam::NonlinearFactorGraph::error), a 0-dim tensor."""
        pose, vel = self._check_traj(traj)
        err = torch.zeros((), dtype=pose.dtype, device=pose.device)
        for g in self._compile(pose.dtype, pose.device):
            err = err + _quad(g.W, g.error(g.params, g.states(pose, vel)))
        return err

    def linearize(self, traj: Trajectory):
        """Block-tridiagonal Gauss-Newton normal equations of the graph:
        (H_diag (n, m, m), H_off (n-1, m, m), b (n, m), err ()), with
        H = J^T W J, b = -J^T W r over the groups' Jacobians. Each group's
        terms are summed per state first (index_add_: duplicate states
        accumulate) and then added once, first state's terms before the
        second's: a graph whose factors are added in the planner's order
        (priors, GP priors, obstacle factors, interpolated factors) sums
        its normal equations in `traj_linearize`'s order."""
        pose, vel = self._check_traj(traj)
        n, m = self.n, 2 * self.space.dim
        kw = dict(dtype=pose.dtype, device=pose.device)
        H_diag = torch.zeros((n, m, m), **kw)
        H_off = torch.zeros((max(n - 1, 0), m, m), **kw)
        b = torch.zeros((n, m), **kw)
        err = torch.zeros((), **kw)

        def scatter(dst, idx, src):
            dst += torch.zeros_like(dst).index_add_(0, idx, src)

        for g in self._compile(pose.dtype, pose.device):
            r, J = g.linearize(g.params, g.states(pose, vel))  # (F, R), (F, R, m | 2m)
            if g.W.dim() == 2:
                Wr, WJ = g.W * r, g.W[..., None] * J
            else:
                Wr = torch.einsum("frs,fs->fr", g.W, r)
                WJ = torch.einsum("frs,fsm->frm", g.W, J)
            err = err + 0.5 * (r * Wr).sum()
            JtWr = (J.mT @ Wr[..., None])[..., 0]
            if g.unary:
                scatter(H_diag, g.i0, J.mT @ WJ)
                scatter(b, g.i0, -JtWr)
                continue
            J1, J2, WJ1, WJ2 = J[..., :m], J[..., m:], WJ[..., :m], WJ[..., m:]
            i1 = g.i0 + 1
            scatter(H_diag, g.i0, J1.mT @ WJ1)
            scatter(H_diag, i1, J2.mT @ WJ2)
            scatter(H_off, g.i0, J1.mT @ WJ2)
            scatter(b, g.i0, -JtWr[..., :m])
            scatter(b, i1, -JtWr[..., m:])
        return H_diag, H_off, b, err

    def optimize(self, init: Trajectory, params: Optional[OptimizerParams] = None) -> OptResult:
        """Solve the graph with the batched GN / LM / Dogleg loop as a
        batch of one (K1 at B = 1; reference: GaussNewton or Dogleg on the
        manual graph, Arm2FactorGraphExample.m:136-148). Default: GN,
        max_iter 100, rel_thresh 1e-5. Returns an unbatched OptResult."""
        if params is None:
            params = OptimizerParams(method="gaussnewton", max_iter=100, rel_thresh=1e-5)
        self._check_traj(init)

        def lin_b(traj_b):
            lin = self.linearize(Trajectory(traj_b.pose[0], traj_b.vel[0]))
            return tuple(x[None] for x in lin)

        res = optimize_batch(lin_b, functools.partial(_retract_traj, self.space),
                             Trajectory(init.pose[None], init.vel[None]), params)
        return OptResult(Trajectory(res.traj.pose[0], res.traj.vel[0]), res.error[0],
                         res.iterations[0], res.converged[0], res.gave_up[0])

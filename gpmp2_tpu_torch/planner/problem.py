"""Trajectory optimization problem: the batched factor program.

Port of gpmp2_tpu/planner/problem.py for vector-space problems (arms and
the planar point robot) and SE(2) problems (the mobile base). The graph
recipe of BatchTrajOptimizer-inl.h:19-84 — start/goal priors, optional
joint/velocity-limit and vehicle-dynamics factors, an obstacle factor per
support state, obs_check_inter GP-interpolated obstacle factors per
interval, and a GP prior per interval — evaluated for a whole batch of
problems at once and accumulated directly into block-tridiagonal normal
equations (H_diag, H_off, b).

State layout: n = total_step + 1 support states; z_i = [pose tangent_i,
vel_i] (m = 2 dof). A batch of B problems shares the robot and every
weight; the start and goal states carry the leading batch dimension, and
the SDF is either shared or carries one world per problem (query rows of
lane b read world b).

The obstacle linearize runs every collision state (support and
interpolated, B * (n + (n-1) * inter) configurations) through one pass of
sphere centres and Jacobians (kernel K2 for arms, closed forms for the
point robot and the mobile base), one SDF lookup (kernel K3), and -g . J:
the branch the JAX package takes when its FK kernel is on
(gpmp2_tpu/planner/problem.py:213-229), the same math as its default
triple product. A planar SDF reads the x and y of the centres, with
gz = 0 (problem.py:215-217, 263-265). `traj_error` and `collision_cost`
take the same lookup.

On SE(2) the Jacobians that the JAX package takes with jax.jacfwd (the
boundary priors, the Lie GP prior, and d local(pose(tau), .)/dz of the
interpolated poses) come from torch.func.jacfwd under torch.func.vmap
on the same functions; the interpolated poses go through the same single
sphere pass and lookup as the support poses, where the JAX package vmaps
them one at a time. The workspace goal, self-collision, workspace priors
and replanning slots are later slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..gp.gputils import calc_Q_inv
from ..gp.interpolator import InterpCoeffs, interp_coeffs, interpolate_pose
from ..gp.prior import gp_prior_error, gp_prior_jacobians_linear
from ..geometry.statespace import StateSpace
from ..kinematics.factors import (joint_limit_error, limit_mask,
                                  velocity_limit_error)
from ..kinematics.fk import ArmFK
from ..kinematics.robot import (RobotModel, sphere_centers_and_jac,
                                sphere_centers_world)
from ..obstacle.factors import hinge_loss
from ..obstacle.sdf import PlanarSDF, SignedDistanceField, sdf_lookup_points
from ..ops.fk_arm import arm_fk_spheres_batched
from ..solver.linearize import (jtwj_diag, jtwj_full, jtwr_diag, jtwr_full,
                                quad_err_diag, quad_err_full)

__all__ = ["Trajectory", "TrajProblem", "traj_error", "traj_linearize",
           "collision_cost"]


class Trajectory(NamedTuple):
    """Support states of a batch: pose (B, n, d), vel (B, n, d)."""

    pose: torch.Tensor
    vel: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrajProblem:
    """A batch of planning problems that share robot and weights; the SDF
    is shared or has one world per problem."""

    robot: RobotModel
    sdf: SignedDistanceField | PlanarSDF
    dt: torch.Tensor  # () delta_t = total_time / total_step
    Qc: torch.Tensor  # (d, d) GP power-spectral-density covariance
    start_pose: torch.Tensor  # (B, d)
    start_vel: torch.Tensor  # (B, d)
    end_pose: torch.Tensor  # (B, d)
    end_vel: torch.Tensor  # (B, d)
    pose_prior_w: torch.Tensor  # (d,) precision diag (start prior)
    vel_prior_w: torch.Tensor  # (d,)
    goal_pose_w: torch.Tensor  # (d,) precision diag (goal prior)
    goal_vel_w: torch.Tensor  # (d,)
    obs_w: torch.Tensor  # () precision 1/cost_sigma^2
    eps: torch.Tensor  # () obstacle safety margin
    taus: torch.Tensor  # (inter,) interpolation offsets within an interval
    # joint limits (used iff the flags are set)
    pos_lim_down: torch.Tensor  # (d,)
    pos_lim_up: torch.Tensor  # (d,)
    pos_lim_thresh: torch.Tensor  # (d,)
    pos_lim_w: torch.Tensor  # (d,)
    vel_lim: torch.Tensor  # (d,)
    vel_lim_thresh: torch.Tensor  # (d,)
    vel_lim_w: torch.Tensor  # (d,)
    dyn_w: torch.Tensor  # () vehicle-dynamics precision (used iff the flag is set)
    N: int = 10  # total_step: number of intervals
    flag_pos_limit: bool = False
    flag_vel_limit: bool = False
    flag_vehicle_dynamics: bool = False

    @property
    def space(self) -> StateSpace:
        return self.robot.space

    @property
    def planar(self) -> bool:
        return isinstance(self.sdf, PlanarSDF)

    def lanes(self, idx) -> "TrajProblem":
        """The problems `idx` of the batch (their worlds too, where the SDF
        has one per problem)."""
        sdf = self.sdf.worlds(idx) if self.sdf.num_worlds else self.sdf
        return dataclasses.replace(
            self, sdf=sdf, **{k: getattr(self, k)[idx] for k in
                              ("start_pose", "start_vel", "end_pose", "end_vel")})

    def to(self, dtype) -> "TrajProblem":
        """The same problems with every float tensor cast to `dtype`."""
        return dataclasses.replace(self, robot=self.robot.to(dtype=dtype),
                                   sdf=self.sdf.to(dtype=dtype), **{
            f.name: getattr(self, f.name).to(dtype) for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    @functools.cached_property
    def gp_precision(self) -> torch.Tensor:
        """Q(dt)^-1, the GP prior's (2d, 2d) precision."""
        return calc_Q_inv(self.Qc, self.dt)

    @functools.cached_property
    def interp(self) -> InterpCoeffs:
        """Lambda/Psi for every tau: (inter, 2d, 2d) each."""
        return interp_coeffs(self.Qc, self.dt, self.taus)


def _interp_confs(prob: TrajProblem, pose, vel):
    """GP-interpolated configurations (B, n-1, inter, d): on a vector space
    conf(tau) = Lambda[:d] [x1; v1] + Psi[:d] [x2; v2]; on SE(2) the Lie
    interpolation (gp/interpolator.py)."""
    d = prob.space.dim
    if not prob.space.is_vector:
        ends = (pose[:, :-1, None], vel[:, :-1, None], pose[:, 1:, None], vel[:, 1:, None])
        return interpolate_pose(prob.space, prob.interp, *ends)
    s1 = torch.cat([pose[:, :-1], vel[:, :-1]], dim=-1)  # (B, n-1, 2d)
    s2 = torch.cat([pose[:, 1:], vel[:, 1:]], dim=-1)
    lam_p, psi_p = prob.interp.lam[:, :d, :], prob.interp.psi[:, :d, :]
    return (torch.einsum("tde,bie->bitd", lam_p, s1)
            + torch.einsum("tde,bie->bitd", psi_p, s2))


def _collision_confs(prob: TrajProblem, pose, vel):
    """Support then interpolated configurations: (B, n + (n-1) inter, d)."""
    B, n, d = pose.shape
    if prob.taus.shape[0] == 0:
        return pose
    confs = _interp_confs(prob, pose, vel)
    return torch.cat([pose, confs.reshape(B, -1, d)], dim=1)


def _obs_res_and_jac_batched(prob: TrajProblem, confs):
    """Hinge residuals (B, C, S) and Jacobians (B, C, S, d) for
    configurations (B, C, d): sphere centres and Jacobians (K2 for arms),
    one SDF lookup (K3), then -g . J on active spheres; inactive and
    out-of-range rows are zero (ObstacleSDFFactor-inl.h:40-57,
    ObstaclePlanarSDFFactor-inl.h:40-55, ObstacleCost.h:31-49)."""
    if isinstance(prob.robot.fk, ArmFK):
        centers, Jc = arm_fk_spheres_batched(prob.robot, confs)
    else:
        centers, Jc = sphere_centers_and_jac(prob.robot, confs)
    eps_total = prob.robot.sphere_radii + prob.eps  # (S,)
    dist, gx, gy, *gz, ok = sdf_lookup_points(prob.sdf, centers)
    dot = gx[..., None] * Jc[..., 0, :] + gy[..., None] * Jc[..., 1, :]
    if gz:
        dot = dot + gz[0][..., None] * Jc[..., 2, :]
    active = ok & (dist <= eps_total)
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    r = torch.where(active, eps_total - dist, zero)
    J = torch.where(active[..., None], -dot, zero)
    return r, J


def _obs_err_batched(prob: TrajProblem, confs):
    """Hinge residuals (B, C, S) for configurations (B, C, d), without
    Jacobians: the error-only twin of `_obs_res_and_jac_batched`, through
    the same lookup."""
    centers = sphere_centers_world(prob.robot, confs)
    dist, *_, ok = sdf_lookup_points(prob.sdf, centers)
    return hinge_loss(dist, prob.robot.sphere_radii + prob.eps, ok)


def _limit_residuals(prob: TrajProblem, pose, vel):
    """(pose residual, weight, slope) of the joint limits and (vel residual,
    weight, slope) of the velocity limits, each None when its flag is off.
    The slope is d r / d x on the diagonal: -1 below, 0 inside, +1 above
    (JointLimitCost.h:16-32), masked like the residual."""
    def slope(x, lo, hi):
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return torch.where(x < lo, -one, torch.where(x <= hi, 0 * one, one))

    pos = vel_lim = None
    if prob.flag_pos_limit:
        lo = prob.pos_lim_down + prob.pos_lim_thresh
        hi = prob.pos_lim_up - prob.pos_lim_thresh
        r = joint_limit_error(prob.space, pose, prob.pos_lim_down, prob.pos_lim_up,
                              prob.pos_lim_thresh)
        mask = limit_mask(prob.space, pose.dtype, pose.device)
        pos = (r, prob.pos_lim_w, mask * slope(pose, lo, hi))
    if prob.flag_vel_limit:
        lo = -prob.vel_lim + prob.vel_lim_thresh
        hi = prob.vel_lim - prob.vel_lim_thresh
        r = velocity_limit_error(vel, prob.vel_lim, prob.vel_lim_thresh)
        vel_lim = (r, prob.vel_lim_w, slope(vel, lo, hi))
    return pos, vel_lim


def _boundary_residuals(prob: TrajProblem, pose, vel):
    """(state index, pose mean, pose residual, pose weight, vel residual,
    vel weight) of the start and goal priors; the pose residual is
    local(mean, x) (gtsam PriorFactor)."""
    space = prob.space
    return (
        (0, prob.start_pose, space.local(prob.start_pose, pose[:, 0]), prob.pose_prior_w,
         vel[:, 0] - prob.start_vel, prob.vel_prior_w),
        (prob.N, prob.end_pose, space.local(prob.end_pose, pose[:, prob.N]),
         prob.goal_pose_w, vel[:, prob.N] - prob.end_vel, prob.goal_vel_w),
    )


def _gp_residual(prob: TrajProblem, pose, vel):
    return gp_prior_error(prob.space, pose[:, :-1], vel[:, :-1], pose[:, 1:],
                          vel[:, 1:], prob.dt)  # (B, n-1, 2d)


def _dyn_residual(prob: TrajProblem, pose, vel):
    """Vehicle-dynamics residuals (B, n, 1) and their Jacobians (B, n, 1, m)
    wrt [pose tangent, vel] (VehicleDynamics.h:19-40): on SE(2) the
    body-frame v_y, whose Jacobian is a constant row; on a vector state
    [x, y, theta, ...] the world-frame v_y cos(theta) - v_x sin(theta)."""
    d = prob.space.dim
    J = torch.zeros(pose.shape[:-1] + (1, 2 * d), dtype=pose.dtype, device=pose.device)
    J[..., 0, d + 1] = 1.0
    if not prob.space.is_vector:
        return vel[..., 1:2], J
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    vx, vy = vel[..., 0], vel[..., 1]
    J[..., 0, 2] = -vy * s - vx * c
    J[..., 0, d] = -s
    J[..., 0, d + 1] = c
    return (vy * c - vx * s)[..., None], J


def _split_tangent(space, z, p1, v1, p2, v2):
    """The two states of an interval perturbed by z = [dp1, dv1, dp2, dv2]."""
    d = space.dim
    return (space.retract(p1, z[:d]), v1 + z[d:2 * d],
            space.retract(p2, z[2 * d:3 * d]), v2 + z[3 * d:])


def _flat_ends(pose, vel):
    """The interval end states (x1, v1, x2, v2), each (B * (n-1), d)."""
    d = pose.shape[-1]
    return tuple(t.reshape(-1, d) for t in (pose[:, :-1], vel[:, :-1], pose[:, 1:], vel[:, 1:]))


def _prior_pose_jacobian(space, mean, pose):
    """d local(mean, retract(pose, dp)) / d dp at dp = 0: (B, d, d)."""
    def f(dp, mean, p):
        return space.local(mean, space.retract(p, dp))

    return vmap(jacfwd(f), in_dims=(None, 0, 0))(
        torch.zeros_like(pose[0]), mean, pose)


def _lie_gp_jacobians(prob: TrajProblem, pose, vel):
    """Lie GP prior residuals (B, n-1, 2d) and their Jacobians J1, J2
    (B, n-1, 2d, m) wrt z_i and z_{i+1} (gpmp2_tpu/planner/problem.py:599-612)."""
    B, n, d = pose.shape
    m = 2 * d

    def f(z, p1, v1, p2, v2):
        r = gp_prior_error(prob.space, *_split_tangent(prob.space, z, p1, v1, p2, v2),
                           prob.dt)
        return r, r

    z = torch.zeros(2 * m, dtype=pose.dtype, device=pose.device)
    J, r = vmap(jacfwd(f, has_aux=True), in_dims=(None, 0, 0, 0, 0))(
        z, *_flat_ends(pose, vel))
    J = J.reshape(B, n - 1, m, 2 * m)
    return r.reshape(B, n - 1, m), J[..., :m], J[..., m:]


def _interp_pose_jacobians(prob: TrajProblem, pose, vel, pt0):
    """J_mid = d local(pt0, pose(tau; z)) / dz (B, n-1, T, d, 2m) at the
    interpolated poses pt0 (B, n-1, T, d) of every interval and tau
    (gpmp2_tpu/planner/problem.py:689-702)."""
    B, n, d = pose.shape
    T = pt0.shape[2]
    space = prob.space

    def mid(z, p1, v1, p2, v2, lam, psi, p0):
        pt = interpolate_pose(space, InterpCoeffs(lam, psi),
                              *_split_tangent(space, z, p1, v1, p2, v2))
        return space.local(p0, pt)

    per_tau = vmap(jacfwd(mid), in_dims=(None,) * 5 + (0, 0, 0))
    per_interval = vmap(per_tau, in_dims=(None, 0, 0, 0, 0, None, None, 0))
    z = torch.zeros(4 * d, dtype=pose.dtype, device=pose.device)
    J = per_interval(z, *_flat_ends(pose, vel), prob.interp.lam, prob.interp.psi,
                     pt0.reshape(-1, T, d))
    return J.reshape(B, n - 1, T, d, 4 * d)


def traj_error(prob: TrajProblem, traj: Trajectory):
    """Total graph error per problem (B,): 0.5 * sum of whitened squared
    residuals, matching gtsam::NonlinearFactorGraph::error."""
    pose, vel = traj.pose, traj.vel
    err = torch.zeros(pose.shape[0], dtype=pose.dtype, device=pose.device)
    for _, _, rp, wp, rv, wv in _boundary_residuals(prob, pose, vel):
        err = err + quad_err_diag(wp, rp) + quad_err_diag(wv, rv)
    err = err + quad_err_full(prob.gp_precision, _gp_residual(prob, pose, vel))
    confs = _collision_confs(prob, pose, vel)
    err = err + quad_err_diag(prob.obs_w, _obs_err_batched(prob, confs))
    for lim in _limit_residuals(prob, pose, vel):
        if lim is not None:
            err = err + quad_err_diag(lim[1], lim[0])
    if prob.flag_vehicle_dynamics:
        err = err + quad_err_diag(prob.dyn_w, _dyn_residual(prob, pose, vel)[0])
    return err


def traj_linearize(prob: TrajProblem, traj: Trajectory):
    """Gauss-Newton normal equations of a batch: H_diag (B, n, m, m),
    H_off (B, n-1, m, m), b (B, n, m) and error (B,), with H = J^T W J,
    b = -J^T W r, error = 0.5 r^T W r."""
    space = prob.space
    pose, vel = traj.pose, traj.vel
    B, n, d = pose.shape
    m = 2 * d
    kw = dict(dtype=pose.dtype, device=pose.device)
    H_diag = torch.zeros((B, n, m, m), **kw)
    H_off = torch.zeros((B, n - 1, m, m), **kw)
    b = torch.zeros((B, n, m), **kw)
    err = torch.zeros((B,), **kw)

    # ---- boundary priors: identity Jacobians on a vector space, the
    # Jacobian of local(mean, retract(x, .)) on SE(2) -------------------
    for idx, mean, rp, wp, rv, wv in _boundary_residuals(prob, pose, vel):
        err = err + quad_err_diag(wp, rp) + quad_err_diag(wv, rv)
        if space.is_vector:
            H_diag[:, idx, :d, :d] += torch.diag(wp)
            b[:, idx, :d] -= wp * rp
        else:
            Jp = _prior_pose_jacobian(space, mean, pose[:, idx])
            H_diag[:, idx, :d, :d] += jtwj_diag(Jp, wp, Jp)
            b[:, idx, :d] -= jtwr_diag(Jp, wp, rp)
        H_diag[:, idx, d:, d:] += torch.diag(wv)
        b[:, idx, d:] -= wv * rv

    # ---- GP prior per interval: constant Jacobians on a vector space ----
    W_gp = prob.gp_precision
    if space.is_vector:
        gp_r = _gp_residual(prob, pose, vel)
        J1, J2 = gp_prior_jacobians_linear(d, prob.dt, **kw)
    else:
        gp_r, J1, J2 = _lie_gp_jacobians(prob, pose, vel)
    err = err + quad_err_full(W_gp, gp_r)
    H_diag[:, :-1] += jtwj_full(J1, W_gp, J1)
    H_diag[:, 1:] += jtwj_full(J2, W_gp, J2)
    H_off += jtwj_full(J1, W_gp, J2)
    b[:, :-1] -= jtwr_full(J1, W_gp, gp_r)
    b[:, 1:] -= jtwr_full(J2, W_gp, gp_r)

    # ---- obstacle factors: support + interpolated states, one FK pass and
    # one SDF lookup ------------------------------------------------------
    T = prob.taus.shape[0]
    all_confs = _collision_confs(prob, pose, vel)
    r_all, J_all = _obs_res_and_jac_batched(prob, all_confs)
    S = r_all.shape[-1]
    W = prob.obs_w
    obs_r, obs_J = r_all[:, :n], J_all[:, :n]
    err = err + quad_err_diag(W, obs_r)
    H_diag[:, :, :d, :d] += jtwj_diag(obs_J, W, obs_J)
    b[:, :, :d] -= jtwr_diag(obs_J, W, obs_r)

    if T > 0:
        # Factored Gram: contract the sphere axis in configuration space
        # first, then push through d conf(tau) / d [z_i; z_i+1]: the
        # constant [Lambda | Psi][:d] (T, d, 2m) on a vector space, the
        # per-state J_mid (B, n-1, T, d, 2m) on SE(2). Reassociation of
        # J_z = J_conf @ coeff; the widened (B, n-1, T, S, 2m) Jacobian is
        # never built.
        rs = r_all[:, n:].reshape(B, n - 1, T, S)
        Jconf = J_all[:, n:].reshape(B, n - 1, T, S, d)
        if space.is_vector:
            coeff, c = torch.cat([prob.interp.lam[:, :d, :], prob.interp.psi[:, :d, :]],
                                 dim=-1), "t"
        else:
            coeff = _interp_pose_jacobians(prob, pose, vel,
                                           all_confs[:, n:].reshape(B, n - 1, T, d))
            c = "bit"
        G = torch.einsum("bitsd,bitsf->bitdf", Jconf, Jconf)
        g_c = torch.einsum("bitsd,bits->bitd", Jconf, rs)
        GC = torch.einsum(f"bitdf,{c}fF->bitdF", G, coeff)
        Hfull = W * torch.einsum(f"{c}dE,bitdF->biEF", coeff, GC)  # (B, n-1, 2m, 2m)
        gfull = W * torch.einsum(f"{c}dE,bitd->biE", coeff, g_c)  # (B, n-1, 2m)
        err = err + quad_err_diag(W, rs)
        H_diag[:, :-1] += Hfull[..., :m, :m]
        H_diag[:, 1:] += Hfull[..., m:, m:]
        H_off += Hfull[..., :m, m:]
        b[:, :-1] -= gfull[..., :m]
        b[:, 1:] -= gfull[..., m:]

    # ---- joint / velocity limits: diagonal -1/0/+1 Jacobians ------------
    eye_d = torch.eye(d, **kw)
    for lim, blk in zip(_limit_residuals(prob, pose, vel),
                        (slice(None, d), slice(d, None))):
        if lim is not None:
            r, w, sl = lim
            err = err + quad_err_diag(w, r)
            H_diag[:, :, blk, blk] += (w * sl * sl)[..., None] * eye_d
            b[:, :, blk] -= w * sl * r

    # ---- vehicle dynamics -------------------------------------------------
    if prob.flag_vehicle_dynamics:
        r, J = _dyn_residual(prob, pose, vel)
        err = err + quad_err_diag(prob.dyn_w, r)
        H_diag += jtwj_diag(J, prob.dyn_w, J)
        b -= jtwr_diag(J, prob.dyn_w, r)

    return H_diag, H_off, b, err


def collision_cost(prob: TrajProblem, poses):
    """Sum of raw (unwhitened, eps = 0) obstacle errors over the given poses
    (B, n, d) -> (B,): the reference's trajectory-quality metric
    (BatchTrajOptimizer-inl.h:87-100)."""
    prob0 = dataclasses.replace(prob, eps=torch.zeros_like(prob.eps))
    return _obs_err_batched(prob0, poses).reshape(poses.shape[0], -1).sum(-1)

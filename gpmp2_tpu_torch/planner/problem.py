"""Trajectory optimization problem: the batched factor program.

Port of gpmp2_tpu/planner/problem.py for vector-space problems (arms and
the planar point robot), SE(2) problems (the mobile base) and SE(2) x R^n
problems (the mobile manipulators). The graph recipe of
BatchTrajOptimizer-inl.h:19-84 — start/goal priors, optional
joint/velocity-limit and vehicle-dynamics factors, an obstacle factor per
support state, obs_check_inter GP-interpolated obstacle factors per
interval, and a GP prior per interval — plus the JAX package's extension
slots: an end-effector goal in place of the goal-configuration prior
(GoalFactorArm.h), self-collision at every support state
(SelfCollision.h) and workspace prior slots
(GaussianPriorWorkspacePose.h), evaluated for a whole batch of problems
at once and accumulated directly into block-tridiagonal normal equations
(H_diag, H_off, b).

State layout: n = total_step + 1 support states; z_i = [pose tangent_i,
vel_i] (m = 2 dof). A batch of B problems shares the robot and every
weight; the start and goal states (and the end-effector goal) carry the
leading batch dimension, and the SDF is either shared or carries one
world per problem (query rows of lane b read world b).

The obstacle linearize runs every collision state (support and
interpolated, B * (n + (n-1) * inter) configurations) through one pass of
sphere centres and Jacobians (kernel K2 for arms, closed forms for the
point robot and the mobile families), one SDF lookup (kernel K3), and
-g . J: the branch the JAX package takes when its FK kernel is on
(gpmp2_tpu/planner/problem.py:213-229), the same math as its default
triple product. A planar SDF reads the x and y of the centres, with
gz = 0 (problem.py:215-217, 263-265). The self-collision factors reuse the
support states' centres and Jacobians of that pass. `traj_error` and
`collision_cost` take the same lookup.

On SE(2) the Jacobians that the JAX package takes with jax.jacfwd (the
boundary priors, the Lie GP prior, and d local(pose(tau), .)/dz of the
interpolated poses) come from torch.func.jacfwd under torch.func.vmap
on the same functions; the interpolated poses go through the same single
sphere pass and lookup as the support poses, where the JAX package vmaps
them one at a time. On SE(2) x R^n those Jacobians are block-separable:
the chart operations act blockwise and Lambda(tau), Psi(tau) are
(2 x 2) (x) I_d (Qc cancels in Q(tau) Phi^T Q(dt)^-1), so the SE(2) block
takes the SE(2) functions on the first three coordinates and the R^n block
is constant. The end-effector goal takes the analytic point Jacobian of
its link's origin, the workspace slots torch.func.jacfwd, as in the JAX
package. The replanning slots pin a state's pose and velocity per lane
with diagonal priors (gtsam PriorFactor), routed to their states by a
per-lane one-hot; their pose Jacobian is the boundary priors'.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..dynamics import simple_2d_vehicle_dynamics_pose2, simple_2d_vehicle_dynamics_vector3
from ..gp.gputils import calc_Q_inv
from ..gp.interpolator import InterpCoeffs, interp_coeffs, interpolate_pose
from ..gp.prior import gp_prior_error, gp_prior_jacobians_linear
from ..geometry.statespace import SE2Space, StateSpace
from ..kinematics.factors import (goal_factor_error, joint_limit_error, limit_mask,
                                  velocity_limit_error, workspace_pose_error)
from ..kinematics.fk import ArmFK, num_links_of
from ..kinematics.robot import (RobotModel, points_and_jac, sphere_centers_and_jac,
                                sphere_centers_world)
from ..obstacle.factors import hinge_loss, self_collision_terms
from ..obstacle.sdf import PlanarSDF, SignedDistanceField, sdf_lookup_points
from ..ops import assemble
from ..ops.fk_arm import arm_fk_spheres_batched
from ..solver.linearize import (jtwj_diag, jtwj_full, jtwr_diag, jtwr_full,
                                quad_err_diag, quad_err_full)

__all__ = ["Trajectory", "TrajProblem", "LANE_FIELDS", "traj_error", "traj_linearize",
           "collision_cost", "self_collision_cost"]


class Trajectory(NamedTuple):
    """Support states of a batch: pose (B, n, d), vel (B, n, d)."""

    pose: torch.Tensor
    vel: torch.Tensor


# the fields of TrajProblem that carry the leading batch axis B, each with
# the number of dims after it; every other field is shared by the batch
LANE_FIELDS = {"start_pose": 1, "start_vel": 1, "end_pose": 1, "end_vel": 1,
               "goal_pose_w": 1, "goal_vel_w": 1, "goal_point": 1, "extra_idx": 1,
               "extra_pose": 2, "extra_vel": 2, "extra_pose_w": 2, "extra_vel_w": 2}


@dataclasses.dataclass(frozen=True)
class TrajProblem:
    """A batch of planning problems that share robot and weights, but for
    the per-lane fields (LANE_FIELDS); the SDF is shared or has one world
    per problem."""

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
    goal_pose_w: torch.Tensor  # (B, d) precision diag (goal prior; zero = removed)
    goal_vel_w: torch.Tensor  # (B, d)
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
    # end-effector goal, in place of the goal prior (used iff goal_region)
    goal_point: torch.Tensor  # (B, 3)
    goal_w: torch.Tensor  # () precision
    # self-collision at every support state (SelfCollision.h); no pairs = off
    sc_pairs_a: torch.Tensor  # (P,) int64 sphere indices
    sc_pairs_b: torch.Tensor  # (P,) int64
    sc_eps: torch.Tensor  # (P,) per-pair safety margins
    sc_w: torch.Tensor  # (P,) per-pair precisions
    # Kw workspace prior slots, shared by the batch: slot k pins link
    # ws_link[k]'s frame at support state ws_idx[k] (zero weight = off)
    ws_idx: torch.Tensor  # (Kw,) int64 state index
    ws_link: torch.Tensor  # (Kw,) int64 link index
    ws_rot: torch.Tensor  # (Kw, 3, 3) desired orientation
    ws_point: torch.Tensor  # (Kw, 3) desired position
    ws_pos_w: torch.Tensor  # (Kw, 3) position precision
    ws_rot_w: torch.Tensor  # (Kw, 3) orientation precision
    # K replanning prior slots per lane: slot k of lane b pins the pose and
    # velocity of support state extra_idx[b, k] (zero weights = off)
    extra_idx: torch.Tensor  # (B, K) int64 state index
    extra_pose: torch.Tensor  # (B, K, d) pose mean
    extra_vel: torch.Tensor  # (B, K, d) velocity mean
    extra_pose_w: torch.Tensor  # (B, K, d) pose precision diag
    extra_vel_w: torch.Tensor  # (B, K, d) velocity precision diag
    N: int = 10  # total_step: number of intervals
    flag_pos_limit: bool = False
    flag_vel_limit: bool = False
    flag_vehicle_dynamics: bool = False
    goal_region: bool = False  # end-effector goal instead of the goal prior

    @property
    def space(self) -> StateSpace:
        return self.robot.space

    @property
    def planar(self) -> bool:
        return isinstance(self.sdf, PlanarSDF)

    @property
    def flag_self_collision(self) -> bool:
        return self.sc_pairs_a.shape[0] > 0

    @property
    def num_ws(self) -> int:
        return self.ws_idx.shape[0]

    @property
    def num_extra(self) -> int:
        return self.extra_idx.shape[1]

    def lanes(self, idx) -> "TrajProblem":
        """The problems `idx` of the batch: the rows of every per-lane field
        (LANE_FIELDS), and their worlds where the SDF has one per problem."""
        sdf = self.sdf.worlds(idx) if self.sdf.num_worlds else self.sdf
        return dataclasses.replace(
            self, sdf=sdf, **{k: getattr(self, k)[idx] for k in LANE_FIELDS})

    def to(self, dtype) -> "TrajProblem":
        """The same problems with every float tensor cast to `dtype`; the
        integer index fields stay as they are."""
        return dataclasses.replace(self, robot=self.robot.to(dtype=dtype),
                                   sdf=self.sdf.to(dtype=dtype), **{
            f.name: v.to(dtype) for f in dataclasses.fields(self)
            if torch.is_tensor(v := getattr(self, f.name)) and v.is_floating_point()})

    @functools.cached_property
    def gp_precision(self) -> torch.Tensor:
        """Q(dt)^-1, the GP prior's (2d, 2d) precision."""
        return calc_Q_inv(self.Qc, self.dt)

    @functools.cached_property
    def interp(self) -> InterpCoeffs:
        """Lambda/Psi for every tau: (inter, 2d, 2d) each."""
        return interp_coeffs(self.Qc, self.dt, self.taus)

    @functools.cached_property
    def interp_coeff(self) -> torch.Tensor:
        """[Lambda | Psi][:d] for every tau, (inter, d, 4d): on a vector
        space d conf(tau) / d [z_i; z_i+1], the same for every interval."""
        d = self.space.dim
        return torch.cat([self.interp.lam[:, :d, :], self.interp.psi[:, :d, :]], dim=-1)

    @functools.cached_property
    def gp_jacobians(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The vector-space GP prior's constant Jacobians (J1, J2), (2d, 2d)
        each."""
        return gp_prior_jacobians_linear(self.space.dim, self.dt, dtype=self.dt.dtype,
                                         device=self.dt.device)


class _SE2Block(NamedTuple):
    """The SE(2) block of an SE(2) x R^n problem, as the Lie GP prior's
    Jacobian helper reads a problem: its space and dt."""

    space: StateSpace
    dt: torch.Tensor


def _se2_cols(d, device, k=2):
    """Indices of the SE(2) dims in k stacked d-dim tangents: for k = 2,
    [0, 1, 2, d, d + 1, d + 2] of z = [pose tangent, vel]."""
    return torch.cat([torch.arange(3, device=device) + j * d for j in range(k)])


def _vec_cols(d, device, k=2):
    """Indices of the R^n dims in k stacked d-dim tangents."""
    return torch.cat([torch.arange(3, d, device=device) + j * d for j in range(k)])


def _se2_block(prob) -> _SE2Block:
    return _SE2Block(SE2Space(), prob.dt)


def _interp_confs(prob: TrajProblem, pose, vel):
    """GP-interpolated configurations (B, n-1, inter, d): on a vector space
    conf(tau) = Lambda[:d] [x1; v1] + Psi[:d] [x2; v2]; on SE(2) and
    SE(2) x R^n the Lie interpolation (gp/interpolator.py)."""
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


def _spheres_and_jac(robot: RobotModel, confs):
    """Sphere centres (..., S, 3) and their Jacobians (..., S, 3, d) for
    configurations (..., d): kernel K2 for arms, the closed forms of
    kinematics/robot.py for the other families. The planner and the
    manual graphs (planner/factor_graph.py, planner/multigraph.py) share
    it."""
    if isinstance(robot.fk, ArmFK):
        return arm_fk_spheres_batched(robot, confs)
    return sphere_centers_and_jac(robot, confs)


def _obs_res_and_jac(robot: RobotModel, sdf, eps, centers, Jc):
    """Hinge residuals (..., S) and Jacobians (..., S, d) of sphere centres
    and their Jacobians: one SDF lookup (K3), then -g . J on active
    spheres; inactive and out-of-range rows are zero
    (ObstacleSDFFactor-inl.h:40-57, ObstaclePlanarSDFFactor-inl.h:40-55,
    ObstacleCost.h:31-49). The lookup's leading axis is the world axis on
    a per-problem field. A 3D field's screen takes eps_total as its
    threshold on every route here (the planner, FactorGraph, the
    multigraph; the JAX package screens these sites,
    gpmp2_tpu/planner/problem.py:183-184, 219-220, 316, but not its fused
    CPU arm route, :260-261): a screened sphere is inactive either way, so
    residuals and Jacobians are those of the unscreened lookup."""
    eps_total = robot.sphere_radii + eps  # (S,)
    dist, gx, gy, *gz, ok = sdf_lookup_points(sdf, centers, eps_total)
    dot = gx[..., None] * Jc[..., 0, :] + gy[..., None] * Jc[..., 1, :]
    if gz:
        dot = dot + gz[0][..., None] * Jc[..., 2, :]
    active = ok & (dist <= eps_total)
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    r = torch.where(active, eps_total - dist, zero)
    J = torch.where(active[..., None], -dot, zero)
    return r, J


def _obs_err(robot: RobotModel, sdf, eps, centers):
    """Hinge residuals (..., S) of sphere centres (..., S, 3), without
    Jacobians: the error-only twin of `_obs_res_and_jac`, through the same
    lookup and screen."""
    eps_total = robot.sphere_radii + eps
    dist, *_, ok = sdf_lookup_points(sdf, centers, eps_total)
    return hinge_loss(dist, eps_total, ok)


def _selfcoll_res(prob: TrajProblem, centers):
    """Self-collision residuals (B, n, P) of the support states' sphere
    centres (B, n, S, 3) (SelfCollision.h:112-132)."""
    return self_collision_terms(centers, prob.robot.sphere_radii, prob.sc_pairs_a,
                                prob.sc_pairs_b, prob.sc_eps)[0]


def _selfcoll_res_and_jac(prob: TrajProblem, centers, Jc):
    """Self-collision residuals (B, n, P) and Jacobians (B, n, P, d) from the
    support states' centres and sphere Jacobians: d dist / dz =
    (c_a - c_b) / dist . (J_a - J_b), negated on active pairs
    (gpmp2_tpu/planner/problem.py:363-382)."""
    a, b = prob.sc_pairs_a, prob.sc_pairs_b
    r, u, active = self_collision_terms(centers, prob.robot.sphere_radii, a, b, prob.sc_eps)
    grad = torch.einsum("...pk,...pkd->...pd", u, Jc[..., a, :, :] - Jc[..., b, :, :])
    return r, torch.where(active[..., None], -grad, torch.zeros_like(grad))


def _goal_res_and_jac(prob: TrajProblem, pose):
    """End-effector goal residual (B, 3) at poses (B, d) and its Jacobian
    (B, 3, d): the last link's origin minus the goal (GoalFactorArm.h:58-77),
    with the analytic point Jacobian of that origin."""
    fk = prob.robot.fk
    ids = torch.full((1,), num_links_of(fk) - 1, dtype=torch.int64, device=pose.device)
    origin, J = points_and_jac(fk, pose, ids, torch.zeros((1, 3), dtype=pose.dtype,
                                                          device=pose.device))
    return origin[:, 0] - prob.goal_point, J[:, 0]


def _ws_args(prob: TrajProblem, pose):
    """The workspace slots' configurations (B, Kw, d) and their link ids,
    orientations and points, each with the batch axis in front."""
    B, K = pose.shape[0], prob.num_ws
    return (pose[:, prob.ws_idx], prob.ws_link.expand(B, K),
            prob.ws_rot.expand(B, K, 3, 3), prob.ws_point.expand(B, K, 3))


def _ws_residuals(prob: TrajProblem, pose):
    """Workspace prior residuals (B, Kw, 6) = [rot err (3), pos err (3)] of
    every slot (GaussianPriorWorkspacePose.h:53-70)."""
    return workspace_pose_error(prob.robot.fk, *_ws_args(prob, pose))


def _ws_res_and_jac(prob: TrajProblem, pose):
    """Workspace prior residuals (B, Kw, 6) and their Jacobians (B, Kw, 6, d)
    wrt the slots' pose tangents, by torch.func.jacfwd as the JAX package
    takes them with jax.jacfwd (gpmp2_tpu/planner/problem.py:782-795)."""
    fk, space = prob.robot.fk, prob.space
    conf, link, rot, point = _ws_args(prob, pose)
    B, K, d = conf.shape

    def f(dp, q, lk, R, p):
        r = workspace_pose_error(fk, space.retract(q, dp), lk, R, p)
        return r, r

    J, r = vmap(jacfwd(f, has_aux=True), in_dims=(None, 0, 0, 0, 0))(
        torch.zeros(d, dtype=conf.dtype, device=conf.device), conf.reshape(-1, d),
        link.reshape(-1), rot.reshape(-1, 3, 3), point.reshape(-1, 3))
    return r.reshape(B, K, 6), J.reshape(B, K, 6, d)


def _ws_weights(prob: TrajProblem):
    """Per-slot precisions (Kw, 6) in the residuals' order."""
    return torch.cat([prob.ws_rot_w, prob.ws_pos_w], dim=-1)


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
    vel weight) of the start prior and, unless the end-effector goal
    replaces it, the goal prior; the pose residual is local(mean, x)
    (gtsam PriorFactor)."""
    space = prob.space
    out = [(0, prob.start_pose, space.local(prob.start_pose, pose[:, 0]), prob.pose_prior_w,
            vel[:, 0] - prob.start_vel, prob.vel_prior_w)]
    if not prob.goal_region:
        out.append((prob.N, prob.end_pose, space.local(prob.end_pose, pose[:, prob.N]),
                    prob.goal_pose_w, vel[:, prob.N] - prob.end_vel, prob.goal_vel_w))
    return out


def _slot_residuals(prob: TrajProblem, pose, vel):
    """The replanning slots' poses (B, K, d), their pose residuals
    local(mean, x) and velocity residuals v - mean (B, K, d) (gtsam
    PriorFactor), each slot at its own lane's state extra_idx[b, k]."""
    idx = prob.extra_idx[..., None].expand(-1, -1, pose.shape[-1])
    xs, vs = torch.gather(pose, 1, idx), torch.gather(vel, 1, idx)
    return xs, prob.space.local(prob.extra_pose, xs), vs - prob.extra_vel


def _gp_residual(prob: TrajProblem, pose, vel):
    return gp_prior_error(prob.space, pose[:, :-1], vel[:, :-1], pose[:, 1:],
                          vel[:, 1:], prob.dt)  # (B, n-1, 2d)


def _dyn_residual(prob: TrajProblem, pose, vel):
    """Vehicle-dynamics residuals (B, n, 1) and their Jacobians (B, n, 1, m)
    wrt [pose tangent, vel] (VehicleDynamics.h:19-40): on SE(2) and
    SE(2) x R^n the body-frame v_y, whose Jacobian is a constant row; on a
    vector state [x, y, theta, ...] the world-frame
    v_y cos(theta) - v_x sin(theta)."""
    d = prob.space.dim
    J = torch.zeros(pose.shape[:-1] + (1, 2 * d), dtype=pose.dtype, device=pose.device)
    J[..., 0, d + 1] = 1.0
    if not prob.space.is_vector:
        return simple_2d_vehicle_dynamics_pose2(vel)[..., None], J
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    vx, vy = vel[..., 0], vel[..., 1]
    J[..., 0, 2] = -vy * s - vx * c
    J[..., 0, d] = -s
    J[..., 0, d + 1] = c
    return simple_2d_vehicle_dynamics_vector3(pose, vel)[..., None], J


def _split_tangent(space, z, *states):
    """States (p1, v1[, p2, v2, ...]) perturbed by z = [dp1, dv1, ...]: each
    pose retracted by its block, each velocity moved by its block."""
    d = space.dim
    out = []
    for k in range(0, len(states), 2):
        out += [space.retract(states[k], z[k * d:(k + 1) * d]),
                states[k + 1] + z[(k + 1) * d:(k + 2) * d]]
    return tuple(out)


def _flat_ends(pose, vel):
    """The interval end states (x1, v1, x2, v2), each (B * (n-1), d)."""
    d = pose.shape[-1]
    return tuple(t.reshape(-1, d) for t in (pose[:, :-1], vel[:, :-1], pose[:, 1:], vel[:, 1:]))


def _prior_pose_jacobian(space, mean, pose):
    """d local(mean, retract(pose, dp)) / d dp at dp = 0: (B, d, d). On
    SE(2) x R^n, the SE(2) Jacobian of the first three dims beside I."""
    if space.kind == "se2_vector":
        J = torch.eye(space.dim, dtype=pose.dtype, device=pose.device).repeat(
            pose.shape[0], 1, 1)
        J[:, :3, :3] = _prior_pose_jacobian(SE2Space(), mean[:, :3], pose[:, :3])
        return J

    def f(dp, mean, p):
        return space.local(mean, space.retract(p, dp))

    return vmap(jacfwd(f), in_dims=(None, 0, 0))(
        torch.zeros_like(pose[0]), mean, pose)


def _lie_gp_jacobians(prob: TrajProblem, pose, vel):
    """Lie GP prior residuals (B, n-1, 2d) and their Jacobians J1, J2
    (B, n-1, 2d, m) wrt z_i and z_{i+1} (gpmp2_tpu/planner/problem.py:599-612)."""
    B, n, d = pose.shape
    m = 2 * d
    if prob.space.kind == "se2_vector":
        return _se2_vector_gp_jacobians(prob, pose, vel)

    def f(z, p1, v1, p2, v2):
        r = gp_prior_error(prob.space, *_split_tangent(prob.space, z, p1, v1, p2, v2),
                           prob.dt)
        return r, r

    z = torch.zeros(2 * m, dtype=pose.dtype, device=pose.device)
    J, r = vmap(jacfwd(f, has_aux=True), in_dims=(None, 0, 0, 0, 0))(
        z, *_flat_ends(pose, vel))
    J = J.reshape(B, n - 1, m, 2 * m)
    return r.reshape(B, n - 1, m), J[..., :m], J[..., m:]


def _se2_vector_gp_jacobians(prob: TrajProblem, pose, vel):
    """The Lie GP prior on SE(2) x R^n, block by block: the SE(2) rows and
    columns from the SE(2) prior on the first three dims, and the R^n rows
    [x2 - x1 - dt v1, v2 - v1] (gp/prior.py) with the constant Jacobians
    -H1 and -H2 of the vector-space prior's [x1 + dt v1 - x2, v1 - v2]."""
    B, n, d = pose.shape
    m = 2 * d
    _, J1s, J2s = _lie_gp_jacobians(_se2_block(prob), pose[..., :3], vel[..., :3])
    H1, H2 = gp_prior_jacobians_linear(d - 3, prob.dt, pose.dtype, pose.device)
    se2, vec = _se2_cols(d, pose.device), _vec_cols(d, pose.device)
    out = []
    for Js, H in ((J1s, H1), (J2s, H2)):
        J = torch.zeros((B, n - 1, m, m), dtype=pose.dtype, device=pose.device)
        J[..., se2[:, None], se2] = Js
        J[..., vec[:, None], vec] = -H
        out.append(J)
    return _gp_residual(prob, pose, vel), out[0], out[1]


def _interp_pose_jacobians(prob: TrajProblem, pose, vel, pt0):
    """J_mid = d local(pt0, pose(tau; z)) / dz (B, n-1, T, d, 2m) at the
    interpolated poses pt0 (B, n-1, T, d) of every interval and tau
    (gpmp2_tpu/planner/problem.py:689-702)."""
    B, n, d = pose.shape
    T = pt0.shape[2]
    J = _interval_interp_jacobians(prob.space, prob.interp, _flat_ends(pose, vel),
                                  pt0.reshape(-1, T, d))
    return J.reshape(B, n - 1, T, d, 4 * d)


def _interval_interp_jacobians(space, coeffs: InterpCoeffs, ends, pt0):
    """d local(pt0, pose(tau; z)) / dz (L, T, d, 4d) of L intervals, each
    with ends (x1, v1, x2, v2) (L, d) perturbed by z = [dx1, dv1, dx2, dv2],
    at their interpolated poses pt0 (L, T, d): Lambda and Psi (T, 2d, 2d)
    shared by the intervals (the planner) or (L, T, 2d, 2d) each their own
    (the manual graphs). On a Lie space by torch.func.jacfwd; on SE(2) x
    R^n the SE(2) block only (`_se2_vector_interp_jacobians`)."""
    if space.kind == "se2_vector":
        return _se2_vector_interp_jacobians(coeffs, ends, pt0)
    d = space.dim

    def mid(z, p1, v1, p2, v2, lam, psi, p0):
        pt = interpolate_pose(space, InterpCoeffs(lam, psi),
                              *_split_tangent(space, z, p1, v1, p2, v2))
        return space.local(p0, pt)

    c = None if coeffs.lam.dim() == 3 else 0
    per_tau = vmap(jacfwd(mid), in_dims=(None,) * 5 + (0, 0, 0))
    per_interval = vmap(per_tau, in_dims=(None, 0, 0, 0, 0, c, c, 0))
    z = torch.zeros(4 * d, dtype=pt0.dtype, device=pt0.device)
    return per_interval(z, *ends, coeffs.lam, coeffs.psi, pt0)


def _se2_vector_interp_jacobians(coeffs: InterpCoeffs, ends, pt0):
    """The interpolation Jacobian on SE(2) x R^n, block by block: the SE(2)
    rows from the SE(2) interpolation of the first three dims, and the
    constant R^n rows of
    q(tau) = x1 + Lambda[q, d:] v1 + Psi[q, :d] (x2 - x1) + Psi[q, d:] v2
    wrt [dx1, dv1, dx2, dv2] of the R^n dims (the cross blocks vanish with
    Lambda and Psi of the form (2 x 2) (x) I_d)."""
    L, T, d = pt0.shape
    dev = pt0.device
    lam, psi = coeffs
    idx = _se2_cols(d, dev)
    Js = _interval_interp_jacobians(
        SE2Space(), InterpCoeffs(lam[..., idx[:, None], idx], psi[..., idx[:, None], idx]),
        tuple(e[..., :3] for e in ends), pt0[..., :3])
    q = torch.arange(3, d, device=dev)
    eye = torch.eye(d - 3, dtype=pt0.dtype, device=dev)
    Jq = torch.cat([eye - psi[..., q[:, None], q], lam[..., q[:, None], d + q],
                    psi[..., q[:, None], q], psi[..., q[:, None], d + q]],
                   dim=-1)  # ([L,] T, d-3, 4(d-3))
    J = torch.zeros((L, T, d, 4 * d), dtype=pt0.dtype, device=dev)
    J[..., :3, _se2_cols(d, dev, 4)] = Js
    J[..., 3:, _vec_cols(d, dev, 4)] = Jq
    return J


def _interp_gram(prob: TrajProblem, coeff, rs, Jconf):
    """The interpolated obstacle factors' widened Gram (B, n-1, 2m, 2m) and
    gradient (B, n-1, 2m) by the factored form: contract the sphere axis in
    configuration space first, then push through d conf(tau) / d
    [z_i; z_i+1], the constant [Lambda | Psi][:d] (T, d, 2m) on a vector
    space, the per-state J_mid (B, n-1, T, d, 2m) on the Lie spaces.
    Reassociation of J_z = J_conf @ coeff; the widened (B, n-1, T, S, 2m)
    Jacobian is never built."""
    c = "t" if coeff.dim() == 3 else "bit"
    G = torch.einsum("bitsd,bitsf->bitdf", Jconf, Jconf)
    g_c = torch.einsum("bitsd,bits->bitd", Jconf, rs)
    GC = torch.einsum(f"bitdf,{c}fF->bitdF", G, coeff)
    Hfull = prob.obs_w * torch.einsum(f"{c}dE,bitdF->biEF", coeff, GC)
    gfull = prob.obs_w * torch.einsum(f"{c}dE,bitd->biE", coeff, g_c)
    return Hfull, gfull


def traj_error(prob: TrajProblem, traj: Trajectory):
    """Total graph error per problem (B,): 0.5 * sum of whitened squared
    residuals, matching gtsam::NonlinearFactorGraph::error."""
    pose, vel = traj.pose, traj.vel
    n = pose.shape[1]
    err = torch.zeros(pose.shape[0], dtype=pose.dtype, device=pose.device)
    for _, _, rp, wp, rv, wv in _boundary_residuals(prob, pose, vel):
        err = err + quad_err_diag(wp, rp) + quad_err_diag(wv, rv)
    if prob.goal_region:
        err = err + quad_err_diag(prob.goal_w, goal_factor_error(
            prob.robot.fk, pose[:, prob.N], prob.goal_point))
    err = err + quad_err_full(prob.gp_precision, _gp_residual(prob, pose, vel))
    centers = sphere_centers_world(prob.robot, _collision_confs(prob, pose, vel))
    err = err + quad_err_diag(prob.obs_w, _obs_err(prob.robot, prob.sdf, prob.eps, centers))
    for lim in _limit_residuals(prob, pose, vel):
        if lim is not None:
            err = err + quad_err_diag(lim[1], lim[0])
    if prob.flag_vehicle_dynamics:
        err = err + quad_err_diag(prob.dyn_w, _dyn_residual(prob, pose, vel)[0])
    if prob.flag_self_collision:
        err = err + quad_err_diag(prob.sc_w, _selfcoll_res(prob, centers[:, :n]))
    if prob.num_ws:
        err = err + quad_err_diag(_ws_weights(prob), _ws_residuals(prob, pose))
    if prob.num_extra:
        _, rp, rv = _slot_residuals(prob, pose, vel)
        err = err + quad_err_diag(prob.extra_pose_w, rp) + quad_err_diag(prob.extra_vel_w, rv)
    return err


def _assembly_operands(prob: TrajProblem, pose, vel, centers, Jc):
    """The assembly kernel's operands (ops/assemble.py) of a vector-space
    problem: the states, the spheres' Jacobians, the lookup of their
    centres (K3, screened with eps_total as `_obs_res_and_jac` screens
    it), and the priors' means, weights and constants."""
    eps_total = prob.robot.sphere_radii + prob.eps
    dist, gx, gy, *gz, ok = sdf_lookup_points(prob.sdf, centers, eps_total)
    J1, J2 = prob.gp_jacobians
    return (pose.contiguous(), vel.contiguous(), Jc.contiguous(), dist, gx, gy,
            gz[0] if gz else None, ok, eps_total, prob.obs_w, prob.interp_coeff, J1, J2,
            prob.gp_precision, prob.start_pose, prob.start_vel, prob.pose_prior_w,
            prob.vel_prior_w, prob.end_pose, prob.end_vel, prob.goal_pose_w,
            prob.goal_vel_w, not prob.goal_region)


def traj_linearize(prob: TrajProblem, traj: Trajectory):
    """Gauss-Newton normal equations of a batch: H_diag (B, n, m, m),
    H_off (B, n-1, m, m), b (B, n, m) and error (B,), with H = J^T W J,
    b = -J^T W r, error = 0.5 r^T W r. On a vector space on the card
    (`ops.assemble.route`) the boundary priors, the GP prior and the
    obstacle factors come from one launch of the assembly kernel; the
    torch code below is its twin, the CPU path and the Lie spaces' route."""
    space = prob.space
    pose, vel = traj.pose, traj.vel
    B, n, d = pose.shape
    m = 2 * d
    kw = dict(dtype=pose.dtype, device=pose.device)
    # one FK pass over the support and interpolated states (K2 for arms)
    T = prob.taus.shape[0]
    all_confs = _collision_confs(prob, pose, vel)
    centers, Jc = _spheres_and_jac(prob.robot, all_confs)

    def add_pose_factor(idx, r, J, W):
        """A factor on the pose tangent of state(s) idx: r (B, ..., R),
        J (B, ..., R, d)."""
        nonlocal err
        err = err + quad_err_diag(W, r)
        H_diag[:, idx, :d, :d] += jtwj_diag(J, W, J)
        b[:, idx, :d] -= jtwr_diag(J, W, r)

    if assemble.route(space.is_vector, pose.is_cuda, pose.dtype, d, Jc.shape[-3], T):
        H_diag, H_off, b, err = assemble.assemble_vec_cuda(
            *_assembly_operands(prob, pose, vel, centers, Jc))
        if prob.goal_region:
            add_pose_factor(prob.N, *_goal_res_and_jac(prob, pose[:, prob.N]), prob.goal_w)
    else:
        H_diag = torch.zeros((B, n, m, m), **kw)
        H_off = torch.zeros((B, n - 1, m, m), **kw)
        b = torch.zeros((B, n, m), **kw)
        err = torch.zeros((B,), **kw)

        # ---- boundary priors: identity Jacobians on a vector space, the
        # Jacobian of local(mean, retract(x, .)) on the Lie spaces -------
        for idx, mean, rp, wp, rv, wv in _boundary_residuals(prob, pose, vel):
            if space.is_vector:
                err = err + quad_err_diag(wp, rp)
                H_diag[:, idx, :d, :d] += torch.diag_embed(wp)
                b[:, idx, :d] -= wp * rp
            else:
                add_pose_factor(idx, rp, _prior_pose_jacobian(space, mean, pose[:, idx]), wp)
            err = err + quad_err_diag(wv, rv)
            H_diag[:, idx, d:, d:] += torch.diag_embed(wv)
            b[:, idx, d:] -= wv * rv
        if prob.goal_region:
            add_pose_factor(prob.N, *_goal_res_and_jac(prob, pose[:, prob.N]), prob.goal_w)

        # ---- GP prior per interval: constant Jacobians on a vector space
        W_gp = prob.gp_precision
        if space.is_vector:
            gp_r = _gp_residual(prob, pose, vel)
            J1, J2 = prob.gp_jacobians
        else:
            gp_r, J1, J2 = _lie_gp_jacobians(prob, pose, vel)
        err = err + quad_err_full(W_gp, gp_r)
        H_diag[:, :-1] += jtwj_full(J1, W_gp, J1)
        H_diag[:, 1:] += jtwj_full(J2, W_gp, J2)
        H_off += jtwj_full(J1, W_gp, J2)
        b[:, :-1] -= jtwr_full(J1, W_gp, gp_r)
        b[:, 1:] -= jtwr_full(J2, W_gp, gp_r)

        # ---- obstacle factors: support + interpolated states, one SDF
        # lookup ----------------------------------------------------------
        r_all, J_all = _obs_res_and_jac(prob.robot, prob.sdf, prob.eps, centers, Jc)
        S = r_all.shape[-1]
        add_pose_factor(slice(None), r_all[:, :n], J_all[:, :n], prob.obs_w)

        if T > 0:
            if space.is_vector:
                coeff = prob.interp_coeff
            else:
                coeff = _interp_pose_jacobians(prob, pose, vel,
                                               all_confs[:, n:].reshape(B, n - 1, T, d))
            rs = r_all[:, n:].reshape(B, n - 1, T, S)
            Hfull, gfull = _interp_gram(prob, coeff, rs,
                                        J_all[:, n:].reshape(B, n - 1, T, S, d))
            err = err + quad_err_diag(prob.obs_w, rs)
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

    # ---- self-collision on the support states, from the sphere pass ------
    if prob.flag_self_collision:
        add_pose_factor(slice(None), *_selfcoll_res_and_jac(prob, centers[:, :n], Jc[:, :n]),
                        prob.sc_w)

    # ---- workspace prior slots, routed to their states by a one-hot -------
    if prob.num_ws:
        wr, wJ = _ws_res_and_jac(prob, pose)
        W6 = _ws_weights(prob)
        err = err + quad_err_diag(W6, wr)
        oh = (prob.ws_idx[:, None] == torch.arange(n, device=pose.device)).to(pose.dtype)
        H_diag[:, :, :d, :d] += torch.einsum("kn,bkij->bnij", oh, jtwj_diag(wJ, W6, wJ))
        b[:, :, :d] -= torch.einsum("kn,bki->bni", oh, jtwr_diag(wJ, W6, wr))

    # ---- replanning prior slots, routed to their states by a per-lane
    # one-hot: on a vector space diagonal, on the Lie spaces the boundary
    # priors' pose Jacobian; the velocity block adds diag(w) -------------
    if prob.num_extra:
        xs, rp, rv = _slot_residuals(prob, pose, vel)
        wp, wv = prob.extra_pose_w, prob.extra_vel_w
        err = err + quad_err_diag(wp, rp) + quad_err_diag(wv, rv)
        oh = (prob.extra_idx[..., None] == torch.arange(n, device=pose.device)).to(pose.dtype)
        if space.is_vector:
            H_diag[:, :, :d, :d] += torch.diag_embed(torch.einsum("bkn,bki->bni", oh, wp))
            b[:, :, :d] -= torch.einsum("bkn,bki->bni", oh, wp * rp)
        else:
            J = _prior_pose_jacobian(space, prob.extra_pose.reshape(-1, d),
                                     xs.reshape(-1, d)).reshape(xs.shape + (d,))
            H_diag[:, :, :d, :d] += torch.einsum("bkn,bkij->bnij", oh, jtwj_diag(J, wp, J))
            b[:, :, :d] -= torch.einsum("bkn,bki->bni", oh, jtwr_diag(J, wp, rp))
        H_diag[:, :, d:, d:] += torch.diag_embed(torch.einsum("bkn,bki->bni", oh, wv))
        b[:, :, d:] -= torch.einsum("bkn,bki->bni", oh, wv * rv)

    return H_diag, H_off, b, err


def collision_cost(prob: TrajProblem, poses):
    """Sum of raw (unwhitened, eps = 0) obstacle errors over the given poses
    (B, n, d) -> (B,): the reference's trajectory-quality metric
    (BatchTrajOptimizer-inl.h:87-100)."""
    centers = sphere_centers_world(prob.robot, poses)
    return _obs_err(prob.robot, prob.sdf, torch.zeros_like(prob.eps), centers).reshape(
        poses.shape[0], -1).sum(-1)


def self_collision_cost(prob: TrajProblem, poses):
    """Sum of raw (unwhitened, eps = 0) self-collision errors over the
    given poses (B, n, d) -> (B,): zero when no listed sphere pair
    overlaps."""
    prob0 = dataclasses.replace(prob, sc_eps=torch.zeros_like(prob.sc_eps))
    return _selfcoll_res(prob0, sphere_centers_world(prob.robot, poses)).reshape(
        poses.shape[0], -1).sum(-1)

"""Batch trajectory optimization: the planner's entry points.

Port of gpmp2_tpu/planner/batch.py (BatchTrajOptimizer.{h,cpp}) for
vector-space, SE(2) and SE(2) x R^n problems: `make_problem` builds a
batch of problems that share robot and weights, with one shared SDF world
or one per problem; `set_workspace_prior` fills a workspace prior slot;
`plan_batch` optimizes them together; `batch_traj_optimize` does both
from a reference-style setting. Start and goal states carry an explicit
leading batch dimension, so no vmap axes tree is needed.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from ..device import resolve_device
from ..kinematics.fk import num_links_of
from ..kinematics.robot import RobotModel
from ..obstacle.sdf import PlanarSDF, SignedDistanceField, pack_planar_sdf, pack_sdf
from ..solver.optimize import OptimizerParams, OptResult, optimize_batch
from ..utils import trace
from .problem import Trajectory, TrajProblem, collision_cost, traj_linearize
from .settings import TrajOptimizerSetting
from .traj_utils import init_traj_straight_line

__all__ = ["make_problem", "set_workspace_prior", "plan_batch", "batch_traj_optimize",
           "optimizer_params_from_setting", "collision_cost_batch", "SDF_PACK_BUDGET"]

# bytes of packed table that `make_problem` builds by default, unless the
# environment's GPMP2_TPU_SDF_PACK_BUDGET says otherwise (the JAX package's
# default budget, gpmp2_tpu/planner/batch.py:46-75)
SDF_PACK_BUDGET = 2 << 30
# GPMP2_TPU_PACK_DTYPE's values that store a 3D table narrower ("", "none"
# and "auto" keep the field's type)
_PACK_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


def _pack_dtype(sdf):
    """The storage type GPMP2_TPU_PACK_DTYPE asks for a 3D table: None for
    the field's own."""
    name = os.environ.get("GPMP2_TPU_PACK_DTYPE", "")
    if name in ("", "none", "auto") or name == str(sdf.data.dtype).split(".")[-1]:
        return None
    if name not in _PACK_DTYPES:
        raise ValueError(f"GPMP2_TPU_PACK_DTYPE={name!r}: the packed table may be "
                         f"{', '.join(_PACK_DTYPES)} or the field's {sdf.data.dtype}")
    return _PACK_DTYPES[name]


def _maybe_pack_sdf(sdf, sdf_pack):
    """Pack (True), leave unpacked (False), or pack when the packed table,
    counted at the field's bytes times 4 or 8, stays within the budget
    (None). A 3D table is stored in GPMP2_TPU_PACK_DTYPE."""
    if sdf_pack is False or sdf.packed is not None:
        return sdf
    if sdf_pack is None:
        budget = int(os.environ.get("GPMP2_TPU_SDF_PACK_BUDGET", SDF_PACK_BUDGET))
        factor = 2 ** sdf.DIM
        if sdf.data.numel() * sdf.data.element_size() * factor > budget:
            return sdf
    if isinstance(sdf, PlanarSDF):
        return pack_planar_sdf(sdf)
    return pack_sdf(sdf, _pack_dtype(sdf))


def _check_setting(setting: TrajOptimizerSetting, d: int, vehicle_dynamics: bool,
                   space):
    """Constructor-time validation, mirroring the reference's factor-ctor
    throws (JointLimitFactorVector.h:52-56, VelocityLimitFactorVector.h:49-55)."""
    if vehicle_dynamics and space.is_vector and d < 3:
        raise ValueError(
            "make_problem: vehicle dynamics on a vector state needs [x, y, theta, ...], "
            f"got dof {d}")
    if setting.dof != d:
        raise ValueError(
            f"make_problem: setting.dof={setting.dof} does not match the "
            f"robot's dof {d}")
    if setting.flag_vel_limit and (setting.vel_limits <= 0).any():
        raise ValueError(
            "make_problem: vel_limits must be strictly positive when "
            f"flag_vel_limit is set, got {setting.vel_limits.tolist()}")
    if setting.flag_pos_limit and (
            setting.joint_pos_limits_down > setting.joint_pos_limits_up).any():
        raise ValueError(
            "make_problem: joint_pos_limits_down must be <= joint_pos_limits_up, "
            f"got down={setting.joint_pos_limits_down.tolist()} "
            f"up={setting.joint_pos_limits_up.tolist()}")


def _self_collision_table(pairs, robot, dtype, device):
    """(sphere a, sphere b, eps, precision) tensors of a self-collision table
    of rows (sphere_a, sphere_b, eps, sigma) (SelfCollision.h:60); empty
    for None. The FK indexes spheres unchecked, so ids are checked here."""
    table = np.asarray([] if pairs is None else pairs, dtype=np.float64).reshape(-1, 4)
    ids = table[:, :2]
    if (ids != np.round(ids)).any() or (ids < 0).any() or (ids >= robot.num_spheres).any():
        raise ValueError(
            f"make_problem: self-collision sphere ids must be integers in "
            f"[0, {robot.num_spheres}), got {ids[(ids < 0) | (ids >= robot.num_spheres)]}")
    if (table[:, 3] <= 0).any():
        raise ValueError("make_problem: self-collision sigmas must be > 0")
    idx = torch.as_tensor(ids.astype(np.int64), device=device)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    return idx[:, 0], idx[:, 1], f(table[:, 2]), f(1.0 / table[:, 3] ** 2)


def make_problem(
    robot: RobotModel,
    sdf: SignedDistanceField | PlanarSDF,
    start_pose,
    start_vel,
    end_pose,
    end_vel,
    setting: TrajOptimizerSetting,
    *,
    self_collision_pairs=None,
    num_ws: int = 0,
    num_extra: int = 0,
    flag_vehicle_dynamics: bool = False,
    dyn_sigma: float = 1e-3,
    goal_region: bool = False,
    goal_point=None,
    goal_sigma: float = 1e-3,
    dtype=None,
    device=None,
    sdf_pack=None,
) -> TrajProblem:
    """Build a batch of problems from a reference-style setting.

    Graph recipe of BatchTrajOptimizer-inl.h:19-84: delta_t = total_time /
    total_step; interpolated obstacle factors at tau_j = j * delta_t /
    (obs_check_inter + 1), j = 1..obs_check_inter. start/end are (B, d)
    tensors or arrays. The SDF is one shared world or has a world axis of
    size B. Robot and SDF are cast to `dtype` and moved to `device`
    (defaults: start_pose's dtype and device when it is a tensor, else
    float32 on CUDA). `sdf_pack`: True packs the SDF's corner table, False
    leaves it unpacked, None packs when the table fits the budget
    (GPMP2_TPU_SDF_PACK_BUDGET bytes, default SDF_PACK_BUDGET); a 3D
    table is stored in GPMP2_TPU_PACK_DTYPE (float16, bfloat16; default
    the field's type). A screen on the SDF (`screen_sdf`, `screen_boxes`)
    screens the obstacle lookups.
    `flag_vehicle_dynamics` adds the vehicle-dynamics factor at every state,
    with precision 1/dyn_sigma^2 (VehicleDynamics.h).
    `self_collision_pairs`: rows (sphere_a, sphere_b, eps, sigma), one
    self-collision factor per row at every support state (SelfCollision.h).
    `num_ws`: workspace prior slots, off until `set_workspace_prior` fills
    them. `num_extra`: replanning prior slots per problem, off (zero
    weights) until a session fills them (planner/isam2.py).
    `goal_region`: the end configuration's prior is replaced by an
    end-effector goal, the last link's origin at `goal_point` ((3,) or
    (B, 3)) with sigma `goal_sigma` (GoalFactorArm.h)."""
    if dtype is None:
        dtype = start_pose.dtype if torch.is_tensor(start_pose) else torch.float32
        if dtype not in (torch.float32, torch.float64):
            dtype = torch.float32
    if device is None:
        device = start_pose.device if torch.is_tensor(start_pose) else resolve_device()
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731

    d = robot.dof
    _check_setting(setting, d, flag_vehicle_dynamics, robot.space)
    ends = {name: f(v) for name, v in (
        ("start_pose", start_pose), ("start_vel", start_vel),
        ("end_pose", end_pose), ("end_vel", end_vel))}
    batch = {t.shape[0] for t in ends.values() if t.dim() == 2}
    for name, t in ends.items():
        if t.dim() != 2 or t.shape[-1] != d or len(batch) != 1:
            raise ValueError(
                f"make_problem: {name} must have shape (B, {d}) with one B "
                f"for all four, got {tuple(t.shape)}")
    (B,) = batch
    if sdf.num_worlds not in (0, B):
        raise ValueError(
            f"make_problem: the SDF has {sdf.num_worlds} worlds for a batch "
            f"of {B} problems; give one world or one per problem")
    Qc = f(setting.Qc)
    if Qc.shape != (d, d):
        raise ValueError(
            f"make_problem: setting.Qc must have shape ({d}, {d}), got "
            f"{tuple(Qc.shape)}")
    if goal_region and goal_point is None:
        raise ValueError("make_problem: goal_region needs a goal_point")
    goal = f(np.zeros(3) if goal_point is None else goal_point)
    if goal.shape not in ((3,), (B, 3)):
        raise ValueError(f"make_problem: goal_point must be (3,) or ({B}, 3), got "
                         f"{tuple(goal.shape)}")
    if num_ws < 0 or num_extra < 0:
        raise ValueError(f"make_problem: num_ws and num_extra must be >= 0, got {num_ws} "
                         f"and {num_extra}")
    sc_a, sc_b, sc_eps, sc_w = _self_collision_table(self_collision_pairs, robot, dtype,
                                                     device)

    dt = setting.total_time / setting.total_step
    inter = setting.obs_check_inter
    taus = torch.arange(1, inter + 1, dtype=dtype, device=device) * (dt / (inter + 1))
    ones = torch.ones(d, dtype=dtype, device=device)
    slot = torch.zeros((num_ws,), dtype=torch.int64, device=device)
    extra = torch.zeros((B, num_extra, d), dtype=dtype, device=device)
    return TrajProblem(
        robot=robot.to(dtype=dtype, device=device),
        sdf=_maybe_pack_sdf(sdf.to(dtype=dtype, device=device), sdf_pack),
        dt=f(dt),
        Qc=Qc,
        **ends,
        pose_prior_w=f(1.0 / setting.conf_prior_sigma**2) * ones,
        vel_prior_w=f(1.0 / setting.vel_prior_sigma**2) * ones,
        goal_pose_w=f(1.0 / setting.conf_prior_sigma**2) * ones.repeat(B, 1),
        goal_vel_w=f(1.0 / setting.vel_prior_sigma**2) * ones.repeat(B, 1),
        obs_w=f(1.0 / setting.cost_sigma**2),
        eps=f(setting.epsilon),
        taus=taus,
        pos_lim_down=f(setting.joint_pos_limits_down),
        pos_lim_up=f(setting.joint_pos_limits_up),
        pos_lim_thresh=f(setting.pos_limit_thresh),
        pos_lim_w=f(1.0 / setting.pos_limit_sigma**2),
        vel_lim=f(setting.vel_limits),
        vel_lim_thresh=f(setting.vel_limit_thresh),
        vel_lim_w=f(1.0 / setting.vel_limit_sigma**2),
        dyn_w=f(1.0 / dyn_sigma**2),
        goal_point=goal.expand(B, 3).contiguous(),
        goal_w=f(1.0 / goal_sigma**2),
        sc_pairs_a=sc_a, sc_pairs_b=sc_b, sc_eps=sc_eps, sc_w=sc_w,
        ws_idx=slot, ws_link=slot.clone(),
        ws_rot=torch.eye(3, dtype=dtype, device=device).repeat(num_ws, 1, 1),
        ws_point=torch.zeros((num_ws, 3), dtype=dtype, device=device),
        ws_pos_w=torch.zeros((num_ws, 3), dtype=dtype, device=device),
        ws_rot_w=torch.zeros((num_ws, 3), dtype=dtype, device=device),
        extra_idx=torch.zeros((B, num_extra), dtype=torch.int64, device=device),
        extra_pose=extra, extra_vel=extra.clone(), extra_pose_w=extra.clone(),
        extra_vel_w=extra.clone(),
        N=setting.total_step,
        flag_pos_limit=setting.flag_pos_limit,
        flag_vel_limit=setting.flag_vel_limit,
        flag_vehicle_dynamics=flag_vehicle_dynamics,
        goal_region=goal_region,
    )


def set_workspace_prior(prob: TrajProblem, slot: int, state_idx: int, link_id: int, *,
                        point=None, rot=None, pos_sigma: float = 0.01,
                        rot_sigma: float = 0.01) -> TrajProblem:
    """The problems with workspace prior slot `slot` filled: link
    `link_id`'s frame at support state `state_idx` is pinned to `point`
    (3,) and/or `rot` (3, 3) for every problem of the batch
    (GaussianPriorWorkspacePosition/Orientation/Pose; both for the full
    pose prior)."""
    if not 0 <= slot < prob.num_ws:
        raise ValueError(f"set_workspace_prior: slot {slot} not in [0, {prob.num_ws})")
    if not 0 <= state_idx <= prob.N:
        raise ValueError(f"set_workspace_prior: state {state_idx} not in [0, {prob.N}]")
    n_links = num_links_of(prob.robot.fk)
    if not 0 <= link_id < n_links:
        raise ValueError(f"set_workspace_prior: link {link_id} not in [0, {n_links})")
    upd = {k: getattr(prob, k).clone() for k in
           ("ws_idx", "ws_link", "ws_rot", "ws_point", "ws_pos_w", "ws_rot_w")}
    upd["ws_idx"][slot] = state_idx
    upd["ws_link"][slot] = link_id
    if point is not None:
        upd["ws_point"][slot] = torch.as_tensor(point, dtype=prob.ws_point.dtype)
        upd["ws_pos_w"][slot] = 1.0 / pos_sigma**2
    if rot is not None:
        upd["ws_rot"][slot] = torch.as_tensor(rot, dtype=prob.ws_rot.dtype)
        upd["ws_rot_w"][slot] = 1.0 / rot_sigma**2
    return dataclasses.replace(prob, **upd)


def optimizer_params_from_setting(setting: TrajOptimizerSetting) -> OptimizerParams:
    return OptimizerParams(
        method=setting.opt_type,
        max_iter=setting.max_iter,
        rel_thresh=setting.rel_thresh,
        iter_no_increase=setting.final_iter_no_increase,
        verbosity=setting.verbosity,
    )


def _retract_traj(space, traj: Trajectory, delta) -> Trajectory:
    """Apply the tangent update delta (B, n, 2d) to a batched trajectory."""
    d = space.dim
    return Trajectory(space.retract(traj.pose, delta[..., :d]),
                      traj.vel + delta[..., d:])


def _rescue_gave_up_f64(problems: TrajProblem, init_traj: Trajectory,
                        params: OptimizerParams, res: OptResult) -> OptResult:
    """Re-solve the lanes that gave up in float64, on the same device.

    The reference runs GTSAM in double precision; in float32 the LM lambda
    escalation can hit the rounding floor and give up where double
    precision converges (gpmp2_tpu/planner/batch.py:381-466). The lanes
    that gave up are solved again from their initial trajectory in float64
    through the kernels' float64 instantiations, without the packed SDF
    table (the lookup reads the raw float64 field; a screen stays, in
    float64), and their results are
    scattered back in the input dtype. No-op when nothing gave up."""
    idx = torch.nonzero(res.gave_up).flatten()
    if idx.numel() == 0:
        return res
    f64 = torch.float64
    sub_probs = problems.lanes(idx)
    sub_probs = dataclasses.replace(
        sub_probs, sdf=dataclasses.replace(sub_probs.sdf, packed=None)).to(f64)
    sub_init = Trajectory(init_traj.pose[idx].to(f64), init_traj.vel[idx].to(f64))
    # solved on this rank alone: the lanes that gave up differ between the
    # mesh's dp ranks, so a sharded solve here could not match collectives
    sub = plan_batch(sub_probs, sub_init, dataclasses.replace(
        params, rescue_f64=False, ts_mesh=None, ts_parts=0))

    def scatter(full, part):
        full = full.clone()
        full[idx] = part.to(full.dtype)
        return full

    return OptResult(
        Trajectory(scatter(res.traj.pose, sub.traj.pose),
                   scatter(res.traj.vel, sub.traj.vel)),
        scatter(res.error, sub.error),
        scatter(res.iterations, res.iterations[idx] + sub.iterations),
        scatter(res.converged, sub.converged),
        scatter(res.gave_up, sub.gave_up),
    )


def plan_batch(problems: TrajProblem, init_traj: Trajectory,
               params: OptimizerParams) -> OptResult:
    """Optimize a batch of problems from `init_traj` (pose, vel (B, n, d));
    with `params.rescue_f64`, lanes that gave up are solved again in
    float64. A traced call (utils/trace.py) is one `plan_batch` span, the
    rescue included, with the counts attempts, lanes_active and
    lanes_offered."""
    call = trace.begin()
    try:
        res = optimize_batch(
            functools.partial(traj_linearize, problems),
            functools.partial(_retract_traj, problems.space),
            init_traj, params,
        )
        if params.rescue_f64:
            res = _rescue_gave_up_f64(problems, init_traj, params, res)
    finally:
        if call is not None:
            trace.end(call)
    return res


def batch_traj_optimize(
    robot: RobotModel,
    sdf: SignedDistanceField | PlanarSDF,
    start_pose,
    start_vel,
    end_pose,
    end_vel,
    setting: TrajOptimizerSetting,
    init_traj: Trajectory = None,
    *,
    device=None,
    **problem_kwargs,
) -> OptResult:
    """Single- or multi-problem planner entry point (BatchTrajOptimize +
    optimize(), BatchTrajOptimizer-inl.h:19-84 / .cpp:212-308).

    start/end of shape (B, d) plan a batch; of shape (d,) plan one problem
    and return unbatched results. `init_traj` defaults to the straight
    line (TrajUtils.cpp:25-50). The problems live on `device` (default:
    start_pose's device when it is a tensor, else CUDA)."""
    if device is None:
        device = start_pose.device if torch.is_tensor(start_pose) else resolve_device()
    start_pose, start_vel, end_pose, end_vel = (
        torch.as_tensor(v, device=device) for v in (start_pose, start_vel, end_pose, end_vel))
    batched = start_pose.dim() == 2
    if not batched:
        start_pose, start_vel, end_pose, end_vel = (
            v[None] for v in (start_pose, start_vel, end_pose, end_vel))
        if init_traj is not None:
            init_traj = Trajectory(init_traj.pose[None], init_traj.vel[None])
    probs = make_problem(robot, sdf, start_pose, start_vel, end_pose, end_vel,
                         setting, device=device, **problem_kwargs)
    if init_traj is None:
        init_traj = init_traj_straight_line(
            probs.space, probs.start_pose, probs.end_pose, setting.total_step,
            setting.total_time)
    res = plan_batch(probs, init_traj, optimizer_params_from_setting(setting))
    if batched:
        return res
    return OptResult(Trajectory(res.traj.pose[0], res.traj.vel[0]),
                     res.error[0], res.iterations[0], res.converged[0],
                     res.gave_up[0])


def collision_cost_batch(problems: TrajProblem, traj: Trajectory):
    """The batched CollisionCost metric (BatchTrajOptimizer-inl.h:87-100) of
    each problem's trajectory: (B,). `collision_cost` is batched already;
    this is its name in the JAX package's planner API."""
    return collision_cost(problems, traj.pose)

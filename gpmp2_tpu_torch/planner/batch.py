"""Batch trajectory optimization: the planner's entry points.

Port of gpmp2_tpu/planner/batch.py (BatchTrajOptimizer.{h,cpp}) for arm
problems: `make_problem` builds a batch of problems that share robot, SDF
and weights; `plan_batch` optimizes them together; `batch_traj_optimize`
does both from a reference-style setting. Start and goal states carry an
explicit leading batch dimension, so no vmap axes tree is needed.
"""

from __future__ import annotations

import functools

import torch

from ..kinematics.robot import RobotModel
from ..obstacle.sdf import SignedDistanceField
from ..solver.optimize import OptimizerParams, OptResult, optimize_batch
from .problem import Trajectory, TrajProblem, traj_linearize
from .settings import TrajOptimizerSetting
from .traj_utils import init_traj_straight_line

__all__ = ["make_problem", "plan_batch", "batch_traj_optimize",
           "optimizer_params_from_setting"]


def make_problem(
    robot: RobotModel,
    sdf: SignedDistanceField,
    start_pose,
    start_vel,
    end_pose,
    end_vel,
    setting: TrajOptimizerSetting,
    *,
    dtype=None,
    device=None,
) -> TrajProblem:
    """Build a batch of problems from a reference-style setting.

    Graph recipe of BatchTrajOptimizer-inl.h:19-84: delta_t = total_time /
    total_step; interpolated obstacle factors at tau_j = j * delta_t /
    (obs_check_inter + 1), j = 1..obs_check_inter. start/end are (B, d)
    tensors or arrays; robot and SDF are cast to `dtype` and moved to
    `device` (defaults: start_pose's, else float32 on the SDF's device)."""
    for name in ("flag_pos_limit", "flag_vel_limit"):
        if getattr(setting, name):
            raise NotImplementedError(f"make_problem: {name} is a later slice")
    if dtype is None:
        dtype = start_pose.dtype if torch.is_tensor(start_pose) else torch.float32
        if dtype not in (torch.float32, torch.float64):
            dtype = torch.float32
    if device is None:
        device = start_pose.device if torch.is_tensor(start_pose) else sdf.data.device
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731

    d = robot.dof
    if setting.dof != d:
        raise ValueError(
            f"make_problem: setting.dof={setting.dof} does not match the "
            f"robot's dof {d}")
    ends = {name: f(v) for name, v in (
        ("start_pose", start_pose), ("start_vel", start_vel),
        ("end_pose", end_pose), ("end_vel", end_vel))}
    batch = {t.shape[0] for t in ends.values() if t.dim() == 2}
    for name, t in ends.items():
        if t.dim() != 2 or t.shape[-1] != d or len(batch) != 1:
            raise ValueError(
                f"make_problem: {name} must have shape (B, {d}) with one B "
                f"for all four, got {tuple(t.shape)}")
    Qc = f(setting.Qc)
    if Qc.shape != (d, d):
        raise ValueError(
            f"make_problem: setting.Qc must have shape ({d}, {d}), got "
            f"{tuple(Qc.shape)}")

    dt = setting.total_time / setting.total_step
    inter = setting.obs_check_inter
    taus = torch.arange(1, inter + 1, dtype=dtype, device=device) * (dt / (inter + 1))
    ones = torch.ones(d, dtype=dtype, device=device)
    return TrajProblem(
        robot=robot.to(dtype=dtype, device=device),
        sdf=sdf.to(dtype=dtype, device=device),
        dt=f(dt),
        Qc=Qc,
        **ends,
        pose_prior_w=f(1.0 / setting.conf_prior_sigma**2) * ones,
        vel_prior_w=f(1.0 / setting.vel_prior_sigma**2) * ones,
        goal_pose_w=f(1.0 / setting.conf_prior_sigma**2) * ones,
        goal_vel_w=f(1.0 / setting.vel_prior_sigma**2) * ones,
        obs_w=f(1.0 / setting.cost_sigma**2),
        eps=f(setting.epsilon),
        taus=taus,
        N=setting.total_step,
    )


def optimizer_params_from_setting(setting: TrajOptimizerSetting) -> OptimizerParams:
    return OptimizerParams(
        method=setting.opt_type,
        max_iter=setting.max_iter,
        rel_thresh=setting.rel_thresh,
        iter_no_increase=setting.final_iter_no_increase,
    )


def _retract_traj(space, traj: Trajectory, delta) -> Trajectory:
    """Apply the tangent update delta (B, n, 2d) to a batched trajectory."""
    d = space.dim
    return Trajectory(space.retract(traj.pose, delta[..., :d]),
                      traj.vel + delta[..., d:])


def plan_batch(problems: TrajProblem, init_traj: Trajectory,
               params: OptimizerParams) -> OptResult:
    """Optimize a batch of problems from `init_traj` (pose, vel (B, n, d))."""
    return optimize_batch(
        functools.partial(traj_linearize, problems),
        functools.partial(_retract_traj, problems.space),
        init_traj, params,
    )


def batch_traj_optimize(
    robot: RobotModel,
    sdf: SignedDistanceField,
    start_pose,
    start_vel,
    end_pose,
    end_vel,
    setting: TrajOptimizerSetting,
    init_traj: Trajectory = None,
    **problem_kwargs,
) -> OptResult:
    """Single- or multi-problem planner entry point (BatchTrajOptimize +
    optimize(), BatchTrajOptimizer-inl.h:19-84 / .cpp:212-308).

    start/end of shape (B, d) plan a batch; of shape (d,) plan one problem
    and return unbatched results. `init_traj` defaults to the straight
    line (TrajUtils.cpp:25-50)."""
    batched = torch.as_tensor(start_pose).dim() == 2
    if not batched:
        start_pose, start_vel, end_pose, end_vel = (
            torch.as_tensor(v)[None] for v in (start_pose, start_vel, end_pose, end_vel))
        if init_traj is not None:
            init_traj = Trajectory(init_traj.pose[None], init_traj.vel[None])
    probs = make_problem(robot, sdf, start_pose, start_vel, end_pose, end_vel,
                         setting, **problem_kwargs)
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

"""The port's mobile manipulators against the JAX package, float64 on the CPU.

- SE(2) x R^n chart operations and the SO(3) functions on seeded random
  inputs (rotations at theta = 0, near 0, near pi and pi among them) at
  rtol 1e-12;
- link poses and sphere centres and Jacobians of all five mobile presets
  and of a hand-built Pose2MobileVetLinArmFK with reverse_linact=True, at
  rtol 1e-10, against `link_poses` and `_mobile_sphere_jac`; the presets'
  sphere tables bit-equal to the JAX package's;
- traj_linearize and traj_error at rtol 1e-9 on three batches built from
  the JAX objects' leaves through utils/convert.py: SimpleTwoLinksArm with
  3 interpolated states per interval, vehicle dynamics and a non-diagonal
  Qc (which couples the SE(2) and R^n rows of the GP prior); PR2 on a
  small 3D field with self-collision pairs and a workspace pose slot; and
  SimpleTwoLinksArm with the end-effector goal in place of the goal prior
  (traj_error against the JAX linearize's graph error);
- the self-collision and workspace residuals and Jacobians against the
  JAX package's `_selfcoll_res_and_jac` and `_ws_residuals` (jax.jacfwd);
- a B = 4 SimpleTwoLinksArm LM plan whose final errors match the JAX
  package's at rel 1e-6;
- tests/fixtures/oracle_replan_mobilearm.npz's cold solve within 1% of
  the oracle's cost;
- `TrajProblem.to` keeps the integer index fields integer, the float64
  rescue re-solves forced gave-up SimpleTwoLinksArm lanes (with their
  end-effector goal), and `make_problem` refuses bad self-collision tables
  and a goal region without a goal point.

Each JAX reference is jitted once.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.geometry import so3 as jso3
from gpmp2_tpu.geometry.se3 import Pose3 as JPose3
from gpmp2_tpu.geometry.statespace import SE2VectorSpace as JSE2VectorSpace
from gpmp2_tpu.kinematics import fk as jfk
from gpmp2_tpu.kinematics.robot import _mobile_sphere_jac
from gpmp2_tpu.kinematics.robot import make_robot_model as j_make_robot_model
from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
from gpmp2_tpu.obstacle.sdf import SignedDistanceField as JSDF
from gpmp2_tpu.planner import problem as jproblem
from gpmp2_tpu.planner.batch import infer_batch_axes
from gpmp2_tpu.planner.batch import make_problem as j_make_problem
from gpmp2_tpu.planner.batch import plan_batch as j_plan_batch
from gpmp2_tpu.planner.batch import set_workspace_prior as j_set_workspace_prior
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.planner.settings import TrajOptimizerSetting as JSetting
from gpmp2_tpu.robots import generate_mobile_arm as j_generate_mobile_arm
from gpmp2_tpu.solver.optimize import OptimizerParams as JOptimizerParams
from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
from gpmp2_tpu_torch.geometry import so3
from gpmp2_tpu_torch.geometry.statespace import SE2VectorSpace
from gpmp2_tpu_torch.kinematics.fk import link_poses
from gpmp2_tpu_torch.kinematics.robot import sphere_centers_and_jac, sphere_centers_world
from gpmp2_tpu_torch.obstacle.sdf import sdf_lookup_points
from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting, init_traj_straight_line,
                                     make_problem, optimizer_params_from_setting, plan_batch,
                                     set_workspace_prior, traj_error, traj_linearize)
from gpmp2_tpu_torch.planner.batch import _rescue_gave_up_f64
from gpmp2_tpu_torch.planner.problem import (_collision_confs, _selfcoll_res_and_jac,
                                             _ws_res_and_jac)
from gpmp2_tpu_torch.robots import MOBILE_PRESETS, generate_mobile_arm
from gpmp2_tpu_torch.solver.optimize import OptimizerParams, OptResult
from gpmp2_tpu_torch.utils import convert

F64 = torch.float64
CPU = "cpu"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_replan_mobilearm.npz")
# PR2's left forearm and gripper spheres (links 6 and 8) against the right's
# (links 13 and 15)
PR2_PAIRS = [(a, b, 0.02, 0.05) for a in range(24, 42) for b in range(47, 65)]


def random_states(n, q_dims, seed):
    """(n, 3 + q_dims) SE(2) x R^n states with theta = 0, +pi, -pi and one
    inside the small-angle series among them."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1)),
                        rng.normal(size=(n, q_dims))], 1)
    x[:4, 2] = [0.0, np.pi, -np.pi, 3e-6]
    return x


SPACE_OPS = {
    "retract": (lambda s, a, b: s.retract(a, b)),
    "local": (lambda s, a, b: s.local(a, b)),
    "compose": (lambda s, a, b: s.compose(a, b)),
    "inverse": (lambda s, a, b: s.inverse(a)),
    "expmap": (lambda s, a, b: s.expmap(a)),
    "logmap": (lambda s, a, b: s.logmap(a)),
    "interpolate_linear": (lambda s, a, b: s.interpolate_linear(a, b, 0.3)),
}


@pytest.mark.parametrize("op", list(SPACE_OPS))
def test_se2_vector_ops_match_jax(op):
    a, b = random_states(32, 4, seed=1), random_states(32, 4, seed=2)
    b[4:8] = a[4:8]  # local at the identity
    ref = SPACE_OPS[op](JSE2VectorSpace(4), jnp.asarray(a), jnp.asarray(b))
    space = SE2VectorSpace(4)
    assert space.kind == "se2_vector" and space.dim == 7 and not space.is_vector
    got = SPACE_OPS[op](space, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def random_rotations(seed):
    """Rotations at theta = 0, in the small-angle branch, generic, and near
    and at pi, each as (R, w) with R = Exp(w)."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-5, 1e-3, 0.3, 1.0, 2.0, 2.8, 3.0, np.pi - 1e-5,
                       np.pi - 5e-5, np.pi, 1.5])
    w = axes * angles[:, None]
    return np.array(jax.vmap(jso3.expmap)(jnp.asarray(w))), w


@pytest.mark.parametrize("fn", ["hat", "vee", "expmap", "logmap", "logmap_jacobian"])
def test_so3_matches_jax(fn):
    R, w = random_rotations(3)
    if fn == "hat":
        ref, got = jax.vmap(jso3.hat)(jnp.asarray(w)), so3.hat(torch.from_numpy(w))
    elif fn == "vee":
        W = np.array(jax.vmap(jso3.hat)(jnp.asarray(w)))
        ref, got = jax.vmap(jso3.vee)(jnp.asarray(W)), so3.vee(torch.from_numpy(W))
    elif fn == "expmap":
        ref, got = R, so3.expmap(torch.from_numpy(w))
    elif fn == "logmap":
        ref = jax.jit(jax.vmap(jso3.logmap))(jnp.asarray(R))
        got = so3.logmap(torch.from_numpy(R))
    else:
        # the forward-mode derivative the workspace orientation prior takes;
        # near pi its entries reach ~1e4 (1 / sin theta)
        ref = jax.jit(jax.vmap(jax.jacfwd(jso3.logmap)))(jnp.asarray(R))
        got = torch.func.vmap(torch.func.jacfwd(so3.logmap))(torch.from_numpy(R))
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def _dh(arm):
    return tuple(np.asarray(x) for x in (arm.a, arm.alpha, arm.d, arm.theta_bias))


def _pose(rot, trans):
    return np.asarray(rot), np.asarray(trans)


def port_robot(jrobot, dtype=F64):
    """The port's RobotModel from a JAX mobile manipulator's leaves."""
    fk = jrobot.fk
    table = [np.asarray(x) for x in (jrobot.sphere_link_ids, jrobot.sphere_radii,
                                     jrobot.sphere_centers)]
    kw = dict(dtype=dtype, device=CPU)
    if isinstance(fk, jfk.Pose2MobileArmFK):
        return convert.mobile_arm_from_numpy(
            [_dh(fk.arm)], *table, base_T_arm=_pose(fk.base_T_arm_rot, fk.base_T_arm_trans), **kw)
    if isinstance(fk, jfk.Pose2Mobile2ArmsFK):
        return convert.mobile_arm_from_numpy(
            [_dh(fk.arm1), _dh(fk.arm2)], *table,
            base_T_arm=[_pose(fk.base_T_arm1_rot, fk.base_T_arm1_trans),
                        _pose(fk.base_T_arm2_rot, fk.base_T_arm2_trans)], **kw)
    torso = _pose(fk.base_T_torso_rot, fk.base_T_torso_trans)
    if isinstance(fk, jfk.Pose2MobileVetLinArmFK):
        return convert.mobile_arm_from_numpy(
            [_dh(fk.arm)], *table, base_T_torso=torso,
            torso_T_arm=_pose(fk.torso_T_arm_rot, fk.torso_T_arm_trans),
            reverse_linact=fk.reverse_linact, **kw)
    return convert.mobile_arm_from_numpy(
        [_dh(fk.arm1), _dh(fk.arm2)], *table, base_T_torso=torso,
        torso_T_arm=[_pose(fk.torso_T_arm1_rot, fk.torso_T_arm1_trans),
                     _pose(fk.torso_T_arm2_rot, fk.torso_T_arm2_trans)],
        reverse_linact=fk.reverse_linact, **kw)


def vetlin_reverse():
    """A hand-built Pose2MobileVetLinArmFK with a reversed lift, a rotated
    torso and a 3-link arm."""
    arm = jfk.ArmFK.create([0.3, 0.2, 0.1], [np.pi / 2, 0.0, -np.pi / 2], [0.1, 0.0, 0.05],
                           theta_bias=[0.2, -0.1, 0.0], dtype=jnp.float64)
    torso = JPose3(jso3.rotz(jnp.asarray(0.4)), jnp.asarray([0.1, -0.05, 0.6]))
    mount = JPose3(jso3.rotx(jnp.asarray(-0.3)), jnp.asarray([0.0, 0.15, 0.1]))
    fk = jfk.Pose2MobileVetLinArmFK.create(arm, torso, mount, reverse_linact=True)
    spheres = [(0, 0.2, (0.1, 0.0, 0.1)), (1, 0.1, (0.0, 0.05, -0.2)),
               (2, 0.05, (-0.1, 0.0, 0.0)), (3, 0.05, (0.0, 0.1, 0.0)),
               (4, 0.04, (0.02, 0.0, 0.03)), (4, 0.03, (0.0, 0.0, 0.0))]
    return j_make_robot_model(fk, spheres, dtype=jnp.float64)


@pytest.mark.parametrize("name", list(MOBILE_PRESETS) + ["vetlin_reverse"])
def test_fk_and_sphere_jacobians_match_jax(name):
    if name == "vetlin_reverse":
        jrobot = vetlin_reverse()
        robot = port_robot(jrobot)
    else:
        jrobot = j_generate_mobile_arm(name, dtype=jnp.float64)
        robot = generate_mobile_arm(name, dtype=F64, device=CPU)
        for field in ("sphere_link_ids", "sphere_radii", "sphere_centers"):
            np.testing.assert_array_equal(getattr(robot, field).numpy(),
                                          np.asarray(getattr(jrobot, field)), err_msg=field)
    assert robot.space.kind == "se2_vector" and robot.dof == jfk.dof_of(jrobot.fk)
    q = random_states(24, robot.dof - 3, seed=len(name))
    c_ref, J_ref = jax.jit(jax.vmap(lambda x: _mobile_sphere_jac(jrobot, x)))(jnp.asarray(q))
    poses_ref = jax.vmap(lambda x: jfk.link_poses(jrobot.fk, x))(jnp.asarray(q))
    qt = torch.from_numpy(q)
    poses = link_poses(robot.fk, qt)
    c, J = sphere_centers_and_jac(robot, qt)
    for got, ref in ((poses.rot, poses_ref.rot), (poses.trans, poses_ref.trans),
                     (c, c_ref), (J, J_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-13)
    np.testing.assert_array_equal(sphere_centers_world(robot, qt).numpy(), c.numpy())


def planar_disc_field():
    """A 120^2 planar SDF (cell 0.05 m, origin -3) of one disc of radius
    0.4 at (0.5, 0.2)."""
    n, cell, origin = 120, 0.05, np.array([-3.0, -3.0])
    X, Y = np.meshgrid(origin[0] + cell * np.arange(n), origin[1] + cell * np.arange(n))
    return origin, cell, np.sqrt((X - 0.5) ** 2 + (Y - 0.2) ** 2) - 0.4


def ball_field():
    """A 40^3 SDF (cell 0.1 m, origin (-2, -2, -0.5)) of one ball of radius
    0.3 at (-0.2, 0, 1.0), in front of PR2's shoulders."""
    n, cell, origin = 40, 0.1, np.array([-2.0, -2.0, -0.5])
    g = [origin[k] + cell * np.arange(n) for k in (2, 1, 0)]
    Z, Y, X = np.meshgrid(*g, indexing="ij")
    return origin, cell, np.sqrt((X + 0.2) ** 2 + Y ** 2 + (Z - 1.0) ** 2) - 0.3


def jax_and_port(jrobot, field, starts, goals, setting, ws=None, **kw):
    """The batched JAX problem, its vmap axes, and the port's problem built
    from its leaves through utils/convert.py. `ws`: (state, link, point,
    rot) of one workspace slot."""
    origin, cell, data = field
    if len(origin) == 2:
        jsdf = JPlanarSDF(jnp.asarray(origin), jnp.asarray(cell), jnp.asarray(data))
        sdf = convert.planar_sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU)
    else:
        jsdf = JSDF(jnp.asarray(origin), jnp.asarray(cell), jnp.asarray(data))
        sdf = convert.sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU)
    z = np.zeros_like(starts)
    kw = dict(kw, dtype=jnp.float64, sdf_pack=False, num_ws=0 if ws is None else 1)
    jprob = j_make_problem(jrobot, jsdf, starts, z, goals, z, setting, **kw)
    template = j_make_problem(jrobot, jsdf, starts[0], z[0], goals[0], z[0], setting, **kw)
    if ws is not None:
        state, link, point, rot = ws
        jprob, template = (j_set_workspace_prior(p, 0, state, link, point=point, rot=rot)
                           for p in (jprob, template))
    arrays = {k: np.asarray(getattr(jprob, k)) for k in convert.PROBLEM_ARRAYS}
    tprob = convert.problem_from_numpy(
        port_robot(jrobot), sdf, jprob.N, flag_pos_limit=jprob.flag_pos_limit,
        flag_vehicle_dynamics=jprob.flag_vehicle_dynamics, goal_region=jprob.goal_region,
        dtype=F64, device=CPU, **arrays)
    return jprob, infer_batch_axes(jprob, template), tprob


def mobile_endpoints(B, d, seed):
    rng = np.random.default_rng(seed)
    s = np.concatenate([rng.uniform(-1.0, -0.5, (B, 2)), rng.uniform(-0.3, 0.3, (B, 1)),
                        0.3 * rng.normal(size=(B, d - 3))], 1)
    g = np.concatenate([rng.uniform(0.5, 1.0, (B, 2)), rng.uniform(-0.3, 0.3, (B, 1)),
                        0.3 * rng.normal(size=(B, d - 3))], 1)
    return s, g


def _two_links_case():
    B, d = 3, 5
    Qc = 0.8 * np.eye(d) + 0.25 * (np.ones((d, d)) - np.eye(d))
    setting = JSetting(dof=d, total_step=4, total_time=4.0, cost_sigma=0.1, epsilon=0.2,
                       obs_check_inter=3, opt_type="lm", Qc=Qc)
    s, g = mobile_endpoints(B, d, seed=4)
    return jax_and_port(j_generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64),
                        planar_disc_field(), s, g, setting, flag_vehicle_dynamics=True,
                        dyn_sigma=0.05)


def _pr2_case():
    B, d = 2, 18
    setting = JSetting(dof=d, total_step=3, total_time=3.0, cost_sigma=0.05, epsilon=0.1,
                       obs_check_inter=1, opt_type="lm")
    s, g = mobile_endpoints(B, d, seed=5)
    # the shoulders pan inward at both ends, so the forearms meet: active pairs
    s[:, 4] = g[:, 4] = -0.2
    s[:, 11] = g[:, 11] = 0.2
    ws = (2, 8, [0.3, 0.2, 1.1], np.asarray(jso3.rotz(jnp.asarray(0.5))))
    return jax_and_port(j_generate_mobile_arm("PR2", dtype=jnp.float64), ball_field(), s, g,
                        setting, ws=ws, self_collision_pairs=PR2_PAIRS)


def _goal_region_case():
    B, d = 2, 5
    setting = JSetting(dof=d, total_step=4, total_time=4.0, cost_sigma=0.1, epsilon=0.2,
                       obs_check_inter=0, opt_type="lm")
    s, g = mobile_endpoints(B, d, seed=6)
    return jax_and_port(j_generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64),
                        planar_disc_field(), s, g, setting, goal_region=True,
                        goal_point=[0.8, 0.5, 0.0], goal_sigma=0.05)


CASES = {"two_links_nondiag_qc": _two_links_case, "pr2_selfcoll_ws": _pr2_case,
         "goal_region": _goal_region_case}


@functools.lru_cache(maxsize=None)
def linearize_case(name):
    """(JAX problem, axes, port problem, pose, vel) with perturbed
    trajectories; built once per module."""
    jprob, axes, tprob = CASES[name]()
    rng = np.random.default_rng(7)
    line = init_traj_straight_line(tprob.space, tprob.start_pose, tprob.end_pose, tprob.N,
                                   float(tprob.dt) * tprob.N)
    pose = line.pose.numpy() + 0.15 * rng.normal(size=line.pose.shape)
    vel = line.vel.numpy() + 0.15 * rng.normal(size=line.vel.shape)
    pose[0, 1, 2] = np.pi - 1e-3  # across the wrap
    pose[-1, :, 0] -= 3.0  # the last lane leaves the grid in part
    return jprob, axes, tprob, pose, vel


@pytest.mark.parametrize("name", list(CASES))
def test_linearize_matches_jax(name):
    jprob, axes, tprob, pose, vel = linearize_case(name)
    traj = Trajectory(torch.from_numpy(pose), torch.from_numpy(vel))
    c = sphere_centers_world(tprob.robot, _collision_confs(tprob, traj.pose, traj.vel))
    dist, *_, ok = sdf_lookup_points(tprob.sdf, c)
    active = ok & (dist <= tprob.robot.sphere_radii + tprob.eps)
    assert bool(active.any()) and bool((ok & ~active).any()) and bool((~ok).any())
    if tprob.flag_self_collision:
        r, _ = _selfcoll_res_and_jac(tprob, *sphere_centers_and_jac(tprob.robot, traj.pose))
        assert bool((r > 0).any()) and bool((r == 0).any())

    ref = jax.jit(jax.vmap(jproblem.traj_linearize, in_axes=(axes, 0)))(
        jprob, JTrajectory(jnp.asarray(pose), jnp.asarray(vel)))
    got = traj_linearize(tprob, traj)
    for part, g, r in zip(("H_diag", "H_off", "b", "err"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9, atol=1e-12 * np.abs(r).max(),
                                   err_msg=part)
    # the JAX package's linearize returns its graph error, the value of its
    # traj_error (one compile instead of two)
    np.testing.assert_allclose(traj_error(tprob, traj).numpy(), np.asarray(ref[3]), rtol=1e-9)


def test_selfcoll_and_ws_residuals_match_jax():
    jprob, _, tprob, pose, _ = linearize_case("pr2_selfcoll_ws")
    jspace = jprob.robot.space
    d = tprob.space.dim
    flat = pose.reshape(-1, d)

    def ref_fn(q):
        sc = jproblem._selfcoll_res_and_jac(jprob, q)

        def ws(dp):
            return jproblem._ws_residuals(jprob, jspace.retract(q, dp)[None])[0]

        return sc, ws(jnp.zeros(d)), jax.jacfwd(ws)(jnp.zeros(d))

    (r_ref, J_ref), w_ref, wJ_ref = jax.jit(jax.vmap(ref_fn))(jnp.asarray(flat))
    qt = torch.from_numpy(pose)
    r, J = _selfcoll_res_and_jac(tprob, *sphere_centers_and_jac(tprob.robot, qt))
    np.testing.assert_allclose(r.reshape(-1, r.shape[-1]).numpy(), np.asarray(r_ref),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(J.reshape(-1, *J.shape[-2:]).numpy(), np.asarray(J_ref),
                               rtol=1e-10, atol=1e-12)
    # the slot is pinned at state 2: evaluate it at every state of lane 0
    slot_prob = dataclasses.replace(tprob, ws_idx=torch.zeros(1, dtype=torch.int64))
    w, wJ = _ws_res_and_jac(slot_prob, qt[0][:, None])
    n = pose.shape[1]
    np.testing.assert_allclose(w[:, 0].numpy(), np.asarray(w_ref)[:n], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(wJ[:, 0].numpy(), np.asarray(wJ_ref)[:n], rtol=1e-10,
                               atol=1e-12)


def test_plan_batch_matches_jax():
    B, d = 4, 5
    setting = JSetting(dof=d, total_step=6, total_time=6.0, cost_sigma=0.1, epsilon=0.2,
                       obs_check_inter=0, opt_type="lm", max_iter=50, rel_thresh=1e-2)
    s, g = mobile_endpoints(B, d, seed=8)
    jprob, axes, tprob = jax_and_port(
        j_generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64), planar_disc_field(),
        s, g, setting, flag_vehicle_dynamics=True, dyn_sigma=0.05)
    init = init_traj_straight_line(tprob.space, tprob.start_pose, tprob.end_pose, 6, 6.0)
    # the static loop compiles fastest; every loop gives the same per-lane
    # results (tests/test_solver.py)
    ref = j_plan_batch(jprob, JTrajectory(jnp.asarray(init.pose.numpy()),
                                          jnp.asarray(init.vel.numpy())),
                       JOptimizerParams(method="lm", loop="static"), axes)
    got = plan_batch(tprob, init, OptimizerParams(method="lm"))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.gave_up.numpy(), np.asarray(ref.gave_up))
    assert bool(got.converged.all())
    np.testing.assert_allclose(got.error.numpy(), np.asarray(ref.error), rtol=1e-6)


def test_oracle_cold_solve():
    """The replanning fixture's cold LM solve (SimpleTwoLinksArm, one box,
    10 intervals) from its initial trajectory: within 1% of the oracle's
    final cost, converged and not given up."""
    fx = np.load(FIXTURE)
    occ = np.zeros((300, 300))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    sdf = planar_sdf_from_occupancy(fx["meta_origin"], float(fx["meta_cell"]), occ,
                                    dtype=F64, device=CPU)
    robot = generate_mobile_arm("SimpleTwoLinksArm", dtype=F64, device=CPU)
    setting = TrajOptimizerSetting(
        dof=5, total_step=int(fx["meta_n_steps"]), total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]), cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]), opt_type="lm", max_iter=100,
        rel_thresh=float(fx["meta_rel_tol"]))
    start = torch.as_tensor(fx["meta_start"])[None]
    goal = torch.as_tensor(fx["meta_goal0"])[None]
    z = torch.zeros_like(start)
    probs = make_problem(robot, sdf, start, z, goal, z, setting)
    init = Trajectory(torch.as_tensor(fx["init_pose"])[None],
                      torch.as_tensor(fx["init_vel"])[None])
    line = init_traj_straight_line(probs.space, start, goal, setting.total_step,
                                   setting.total_time)
    np.testing.assert_allclose(line.pose.numpy(), init.pose.numpy(), atol=1e-12)
    res = plan_batch(probs, init, optimizer_params_from_setting(setting))
    assert bool(res.converged[0]) and not bool(res.gave_up[0])
    assert float(res.error[0]) <= float(fx["cold_final_error"]) * 1.01 + 1e-9


def test_to_keeps_integer_fields():
    robot = generate_mobile_arm("PR2", device=CPU)
    origin, cell, data = ball_field()
    sdf = convert.sdf_from_numpy(origin, cell, data, device=CPU)
    setting = TrajOptimizerSetting(dof=18, total_step=3, total_time=3.0)
    s, g = (torch.as_tensor(x, dtype=torch.float32) for x in mobile_endpoints(2, 18, seed=9))
    z = torch.zeros_like(s)
    prob = set_workspace_prior(
        make_problem(robot, sdf, s, z, g, z, setting, self_collision_pairs=PR2_PAIRS,
                     num_ws=2), 1, 2, 8, point=[0.3, 0.2, 1.1])
    prob64 = prob.to(torch.float64)
    for name in ("sc_pairs_a", "sc_pairs_b", "ws_idx", "ws_link"):
        assert getattr(prob64, name).dtype == torch.int64, name
        assert torch.equal(getattr(prob64, name), getattr(prob, name)), name
    assert prob64.robot.sphere_link_ids.dtype == torch.int64
    for name in ("sc_eps", "sc_w", "ws_point", "ws_rot", "goal_point", "start_pose"):
        assert getattr(prob64, name).dtype == torch.float64, name
    assert prob64.ws_idx.tolist() == [0, 2] and prob64.ws_link.tolist() == [0, 8]
    assert prob64.flag_self_collision and prob64.num_ws == 2


def test_rescue_recovers_forced_gave_up_lanes():
    """Forced gave-up lanes of float32 SimpleTwoLinksArm problems with the
    end-effector goal are re-solved in float64 and come back converged, in
    float32, with the errors of those problems solved in float64 directly
    (their goal points went with them)."""
    B, d = 4, 5
    origin, cell, data = planar_disc_field()
    sdf = convert.planar_sdf_from_numpy(origin, cell, data, device=CPU)
    robot = generate_mobile_arm("SimpleTwoLinksArm", device=CPU)
    setting = TrajOptimizerSetting(dof=d, total_step=4, total_time=4.0, cost_sigma=0.1,
                                   obs_check_inter=1, opt_type="lm")
    s, g = (torch.as_tensor(x, dtype=torch.float32) for x in mobile_endpoints(B, d, seed=10))
    goals = torch.stack([g[:, 0] + 0.3, g[:, 1], torch.zeros(B)], -1)
    z = torch.zeros_like(s)
    probs = make_problem(robot, sdf, s, z, g, z, setting, goal_region=True, goal_point=goals,
                         goal_sigma=0.05)
    init = init_traj_straight_line(probs.space, s, g, 4, 4.0)
    params = optimizer_params_from_setting(setting)
    bad = torch.tensor([False, True, False, True])
    forced = OptResult(init, torch.where(bad, torch.inf, 0.0), torch.zeros(B, dtype=torch.int32),
                       ~bad, bad)
    rescued = _rescue_gave_up_f64(probs, init, params, forced)
    assert bool(rescued.converged[bad].all()) and not bool(rescued.gave_up[bad].any())
    assert rescued.traj.pose.dtype == torch.float32
    assert torch.equal(rescued.traj.pose[~bad], init.pose[~bad])
    # the same two problems built in float64 directly, with their own goals
    f64 = torch.float64
    direct = plan_batch(
        make_problem(generate_mobile_arm("SimpleTwoLinksArm", dtype=f64, device=CPU),
                     sdf.to(dtype=f64), s[bad].double(), z[bad].double(), g[bad].double(),
                     z[bad].double(), setting, goal_region=True, goal_point=goals[bad],
                     goal_sigma=0.05, sdf_pack=False),
        init_traj_straight_line(probs.space, s[bad].double(), g[bad].double(), 4, 4.0), params)
    np.testing.assert_allclose(rescued.error[bad].numpy(), direct.error.float().numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("pairs,match", [([(0, 65, 0.02, 0.05)], "sphere ids"),
                                         ([(-1, 3, 0.02, 0.05)], "sphere ids"),
                                         ([(0.5, 3, 0.02, 0.05)], "sphere ids"),
                                         ([(0, 3, 0.02, 0.0)], "sigmas")])
def test_make_problem_refuses_bad_self_collision_table(pairs, match):
    robot = generate_mobile_arm("PR2", device=CPU)
    origin, cell, data = ball_field()
    sdf = convert.sdf_from_numpy(origin, cell, data, device=CPU)
    setting = TrajOptimizerSetting(dof=18, total_step=3, total_time=3.0)
    z = torch.zeros(1, 18)
    with pytest.raises(ValueError, match=match):
        make_problem(robot, sdf, z, z, z, z, setting, self_collision_pairs=pairs)
    with pytest.raises(ValueError, match="goal_point"):
        make_problem(robot, sdf, z, z, z, z, setting, goal_region=True)

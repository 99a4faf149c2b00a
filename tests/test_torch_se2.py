"""The port's SE(2) mobile base against the JAX package, float64 on the CPU.

- SE(2) chart operations on seeded random poses, with theta = 0, +-pi and
  angles inside the small-angle series, at rtol 1e-12 (atol 1e-14 for
  entries that cancel to zero), and the vector and SE(2) `StateSpace`
  chart operations;
- the Lie GP prior residual and its Jacobians J1, J2, and the interpolated
  pose and J_mid = d local(pose(tau), .)/dz, against jax.jacfwd on the
  JAX package's functions at rtol 1e-10;
- the mobile base's sphere centres and Jacobians against
  `_mobile_sphere_jac`;
- traj_linearize / traj_error on a batch of 8 SE(2) problems with vehicle
  dynamics and interpolated obstacle factors (and on point-robot problems
  with [x, y, theta] vector states and world-frame dynamics), built from
  the JAX objects' leaves through utils/convert.py, at rtol 1e-9;
- tests/fixtures/oracle_mobilebase_se2.npz as tests/test_parity_oracle.py
  holds the JAX package: graph cost at the oracle's initial (rel 1e-8)
  and optimized (rel 1e-6) trajectories, the straight-line init (atol
  1e-12), and LM, Dogleg and GN each within 1% of the oracle's final cost;
- the float64 rescue of forced gave-up SE(2) lanes, and the refusal of
  vehicle dynamics on a vector state without a heading.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.geometry import se2 as jse2
from gpmp2_tpu.geometry.statespace import SE2Space as JSE2Space
from gpmp2_tpu.geometry.statespace import StateSpace as JStateSpace
from gpmp2_tpu.gp.gputils import calc_lambda as j_calc_lambda
from gpmp2_tpu.gp.gputils import calc_psi as j_calc_psi
from gpmp2_tpu.gp.interpolator import InterpCoeffs as JInterpCoeffs
from gpmp2_tpu.gp.interpolator import interpolate_state as j_interpolate_state
from gpmp2_tpu.gp.prior import gp_prior_error as j_gp_prior_error
from gpmp2_tpu.kinematics import PointRobotFK as JPointRobotFK
from gpmp2_tpu.kinematics import Pose2MobileBaseFK as JPose2MobileBaseFK
from gpmp2_tpu.kinematics import make_robot_model as j_make_robot_model
from gpmp2_tpu.kinematics.robot import _mobile_sphere_jac
from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
from gpmp2_tpu.planner.batch import infer_batch_axes
from gpmp2_tpu.planner.batch import make_problem as j_make_problem
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.planner.problem import traj_error as j_traj_error
from gpmp2_tpu.planner.problem import traj_linearize as j_traj_linearize
from gpmp2_tpu.planner.settings import TrajOptimizerSetting as JSetting
from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
from gpmp2_tpu_torch.geometry import se2
from gpmp2_tpu_torch.geometry.statespace import SE2Space, StateSpace
from gpmp2_tpu_torch.gp.gputils import calc_lambda, calc_psi
from gpmp2_tpu_torch.gp.interpolator import (InterpCoeffs, interpolate_pose, interpolate_state,
                                             interpolate_velocity)
from gpmp2_tpu_torch.kinematics.fk import Pose2MobileBaseFK
from gpmp2_tpu_torch.kinematics.robot import (make_robot_model, sphere_centers_and_jac,
                                              sphere_centers_world)
from gpmp2_tpu_torch.obstacle.sdf import sdf_lookup_points
from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting, batch_traj_optimize,
                                     init_traj_straight_line, make_problem,
                                     optimizer_params_from_setting, plan_batch, traj_error,
                                     traj_linearize)
from gpmp2_tpu_torch.planner.batch import _rescue_gave_up_f64
from gpmp2_tpu_torch.planner.problem import (_collision_confs, _interp_pose_jacobians,
                                             _lie_gp_jacobians)
from gpmp2_tpu_torch.robots import generate_mobile_base
from gpmp2_tpu_torch.solver.optimize import OptResult
from gpmp2_tpu_torch.utils import convert

F64 = torch.float64
CPU = "cpu"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_mobilebase_se2.npz")


def random_poses(n, seed):
    """(n, 3) poses: random, then theta exactly 0, +pi, -pi, and inside the
    small-angle series (theta^2 < 1e-10)."""
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    p[:4, 2] = [0.0, np.pi, -np.pi, 3e-6]
    return p


SE2_OPS = {
    "theta_wrap": (lambda m, a, b: m.theta_wrap(a[..., 2] * 3.0)),
    "compose": (lambda m, a, b: m.compose(a, b)),
    "inverse": (lambda m, a, b: m.inverse(a)),
    "between": (lambda m, a, b: m.between(a, b)),
    "expmap": (lambda m, a, b: m.expmap(a)),
    "logmap": (lambda m, a, b: m.logmap(a)),
    "retract": (lambda m, a, b: m.retract(a, b)),
    "local": (lambda m, a, b: m.local(a, b)),
    "transform_from": (lambda m, a, b: m.transform_from(a, b[..., :2])),
}


@pytest.mark.parametrize("op", list(SE2_OPS))
def test_se2_ops_match_jax(op):
    a, b = random_poses(64, seed=1), random_poses(64, seed=2)
    b[4:8] = a[4:8]  # local and between at the identity
    ref = SE2_OPS[op](jse2, jnp.asarray(a), jnp.asarray(b))
    got = SE2_OPS[op](se2, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


SPACE_OPS = {
    "retract": (lambda s, a, b: s.retract(a, b)),
    "local": (lambda s, a, b: s.local(a, b)),
    "compose": (lambda s, a, b: s.compose(a, b)),
    "inverse": (lambda s, a, b: s.inverse(a)),
    "expmap": (lambda s, a, b: s.expmap(a)),
    "logmap": (lambda s, a, b: s.logmap(a)),
    "interpolate_linear": (lambda s, a, b: s.interpolate_linear(a, b, 0.3)),
}


@pytest.mark.parametrize("kind", ["vector", "se2"])
@pytest.mark.parametrize("op", list(SPACE_OPS))
def test_state_space_ops_match_jax(kind, op):
    a, b = random_poses(32, seed=9), random_poses(32, seed=10)
    jspace, space = JStateSpace(kind, 3), StateSpace(kind, 3)
    ref = SPACE_OPS[op](jspace, jnp.asarray(a), jnp.asarray(b))
    got = SPACE_OPS[op](space, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_state_space_rejects_unknown_kind():
    with pytest.raises(ValueError, match="se3"):
        StateSpace("se3", 6)


def test_se2_log_jacobian_at_identity_is_finite():
    """The boundary prior at the straight-line init takes Log of the
    identity: forward-mode derivatives there must be finite and equal."""
    x0 = np.zeros((5, 3))
    x0[1:, 2] = [1e-6, -1e-6, 0.5, np.pi]
    ref = jax.jit(jax.vmap(jax.jacfwd(jse2.logmap)))(jnp.asarray(x0))
    got = torch.func.vmap(torch.func.jacfwd(se2.logmap))(torch.from_numpy(x0))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def _interval_states(n, seed):
    rng = np.random.default_rng(seed)
    p1 = random_poses(n, seed)
    p2 = p1 + np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), rng.uniform(-1, 1, (n, 1))], 1)
    p2[:2] = p1[:2]  # coincident poses: Log(x1^-1 x2) = 0
    v1, v2 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    return p1, v1, p2, v2


def test_lie_gp_prior_and_jacobians_match_jax():
    B, n, d = 3, 5, 3
    dt = 0.7
    p1, v1, p2, v2 = _interval_states(B * (n - 1), seed=3)
    space = JSE2Space()

    def jax_rj(p1, v1, p2, v2):
        def f(dz):
            return j_gp_prior_error(space, space.retract(p1, dz[:d]), v1 + dz[d:2 * d],
                                    space.retract(p2, dz[2 * d:3 * d]), v2 + dz[3 * d:], dt)

        return f(jnp.zeros(4 * d)), jax.jacfwd(f)(jnp.zeros(4 * d))

    r_ref, J_ref = jax.jit(jax.vmap(jax_rj))(*(jnp.asarray(x) for x in (p1, v1, p2, v2)))
    # the port's batched form takes trajectories: lay the intervals out as
    # (B * (n-1)) two-state trajectories
    pose = torch.from_numpy(np.stack([p1, p2], 1))
    vel = torch.from_numpy(np.stack([v1, v2], 1))
    prob = _stub_problem(dt)
    r, J1, J2 = _lie_gp_jacobians(prob, pose, vel)
    np.testing.assert_allclose(r[:, 0].numpy(), np.asarray(r_ref), rtol=1e-10, atol=1e-13)
    J = torch.cat([J1, J2], dim=-1)[:, 0]
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=1e-10, atol=1e-13)


@dataclasses.dataclass
class _Stub:
    """What the Lie Jacobian helpers read of a TrajProblem."""

    dt: torch.Tensor
    interp: InterpCoeffs
    space = SE2Space()


def _stub_problem(dt, taus=(0.2, 0.45)):
    Qc = torch.eye(3, dtype=F64) * 0.8
    t = torch.tensor(taus, dtype=F64)
    dt = torch.tensor(dt, dtype=F64)
    return _Stub(dt, InterpCoeffs(calc_lambda(Qc, dt, t), calc_psi(Qc, dt, t)))


def test_lie_interpolation_and_jacobian_match_jax():
    d, dt, taus = 3, 0.7, (0.2, 0.45)
    p1, v1, p2, v2 = _interval_states(12, seed=4)
    space = JSE2Space()
    Qc = jnp.eye(3) * 0.8
    coeffs = [JInterpCoeffs(j_calc_lambda(Qc, dt, t), j_calc_psi(Qc, dt, t)) for t in taus]

    def jax_one(p1, v1, p2, v2, co):
        pt0 = j_interpolate_state(space, co, p1, v1, p2, v2)

        def mid(dz):
            pt = j_interpolate_state(space, co, space.retract(p1, dz[:d]), v1 + dz[d:2 * d],
                                     space.retract(p2, dz[2 * d:3 * d]), v2 + dz[3 * d:])[0]
            return space.local(pt0[0], pt)

        return pt0, jax.jacfwd(mid)(jnp.zeros(4 * d))

    args = [jnp.asarray(x) for x in (p1, v1, p2, v2)]
    refs = [jax.jit(jax.vmap(lambda a, b, c, e: jax_one(a, b, c, e, co)))(*args)
            for co in coeffs]
    prob = _stub_problem(dt, taus)
    ends = [torch.from_numpy(x)[:, None] for x in (p1, v1, p2, v2)]
    pose_t, vel_t = interpolate_state(SE2Space(), prob.interp, *ends)  # (12, T, 3)
    assert torch.equal(interpolate_pose(SE2Space(), prob.interp, *ends), pose_t)
    assert torch.equal(interpolate_velocity(SE2Space(), prob.interp, *ends), vel_t)
    pose = torch.from_numpy(np.stack([p1, p2], 1))
    vel = torch.from_numpy(np.stack([v1, v2], 1))
    J_mid = _interp_pose_jacobians(prob, pose, vel, pose_t[:, None])[:, 0]  # (12, T, 3, 12)
    for k, ((ref_pose, ref_vel), ref_J) in enumerate(refs):
        np.testing.assert_allclose(pose_t[:, k].numpy(), np.asarray(ref_pose), rtol=1e-10,
                                   atol=1e-13)
        np.testing.assert_allclose(vel_t[:, k].numpy(), np.asarray(ref_vel), rtol=1e-10,
                                   atol=1e-13)
        np.testing.assert_allclose(J_mid[:, k].numpy(), np.asarray(ref_J), rtol=1e-10,
                                   atol=1e-13)


SPHERES = [(0, 0.35, (0.0, 0.0, 0.0)), (0, 0.1, (0.3, -0.2, 0.1)), (0, 0.2, (-0.4, 0.1, 0.0))]


def test_mobile_sphere_jacobian_matches_jax():
    q = random_poses(32, seed=5)
    jrobot = j_make_robot_model(JPose2MobileBaseFK(), SPHERES, dtype=jnp.float64)
    robot = make_robot_model(Pose2MobileBaseFK(), SPHERES, dtype=F64, device=CPU)
    c_ref, J_ref = jax.vmap(lambda x: _mobile_sphere_jac(jrobot, x))(jnp.asarray(q))
    c, J = sphere_centers_and_jac(robot, torch.from_numpy(q))
    assert J.shape == (32, 3, 3, 3)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(sphere_centers_world(robot, torch.from_numpy(q)).numpy(),
                                  c.numpy())


def box_field(n=120, cell=0.05, origin=(-3.0, -3.0)):
    """A planar SDF (n x n, cell 0.05 m) with two blocks in its middle."""
    occ = np.zeros((n, n))
    occ[50:70, 40:60] = 1.0
    occ[30:40, 75:95] = 1.0
    field = planar_sdf_from_occupancy(np.array(origin), cell, occ, dtype=F64, device=CPU)
    return field.data.numpy(), np.array(origin), cell


def _linearize_case(kind):
    """A batch of 8 problems with vehicle dynamics in the JAX package and the
    port, and perturbed trajectories whose interpolated states meet active,
    inactive and out-of-range hinges."""
    B = 8
    data, origin, cell = box_field()
    jsdf = JPlanarSDF(jnp.asarray(origin), jnp.asarray(cell), jnp.asarray(data))
    setting = JSetting(dof=3, total_step=4, total_time=6.0, cost_sigma=0.1,
                       obs_check_inter=2, opt_type="lm", Qc=0.7 * np.eye(3))
    rng = np.random.default_rng(6)
    starts = np.stack([rng.uniform(-2.5, -1.5, B), rng.uniform(-2.5, 2.5, B),
                       rng.uniform(-np.pi, np.pi, B)], -1)
    goals = np.stack([rng.uniform(1.5, 3.5, B), rng.uniform(-2.5, 2.5, B),
                      rng.uniform(-np.pi, np.pi, B)], -1)
    if kind == "se2":
        jrobot = j_make_robot_model(JPose2MobileBaseFK(), SPHERES, dtype=jnp.float64)
    else:
        jrobot = j_make_robot_model(JPointRobotFK(3), SPHERES[:1], dtype=jnp.float64)
    zeros = np.zeros_like(starts)
    kw = dict(dtype=jnp.float64, sdf_pack=False, flag_vehicle_dynamics=True, dyn_sigma=0.05)
    jprob = j_make_problem(jrobot, jsdf, starts, zeros, goals, zeros, setting, **kw)
    template = j_make_problem(jrobot, jsdf, starts[0], zeros[0], goals[0], zeros[0],
                              setting, **kw)
    axes = infer_batch_axes(jprob, template)
    leaves = [np.asarray(x) for x in (jrobot.sphere_link_ids, jrobot.sphere_radii,
                                      jrobot.sphere_centers)]
    if kind == "se2":
        robot = convert.mobile_base_from_numpy(*leaves, dtype=F64, device=CPU)
    else:
        robot = convert.point_robot_from_numpy(3, *leaves, dtype=F64, device=CPU)
    sdf = convert.planar_sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU)
    arrays = {k: np.asarray(getattr(jprob, k)) for k in convert.PROBLEM_ARRAYS}
    tprob = convert.problem_from_numpy(robot, sdf, jprob.N, flag_vehicle_dynamics=True,
                                       dtype=F64, device=CPU, **arrays)
    line = init_traj_straight_line(tprob.space, tprob.start_pose, tprob.end_pose, 4, 6.0)
    pose = line.pose.numpy() + 0.3 * rng.normal(size=line.pose.shape)
    vel = line.vel.numpy() + 0.3 * rng.normal(size=line.vel.shape)
    pose[0, 1:3, 2] = [np.pi - 1e-3, -np.pi + 1e-3]  # across the wrap
    pose[1, -1] = tprob.end_pose[1].numpy()  # the goal prior at Log(identity)
    pose[2, :, 0] = pose[2, :, 0] - 2.0  # lane 2 leaves the grid
    return jprob, axes, tprob, pose, vel


@pytest.mark.parametrize("kind", ["se2", "vector3"])
def test_linearize_matches_jax(kind):
    jprob, axes, tprob, pose, vel = _linearize_case(kind)
    ttraj = Trajectory(torch.from_numpy(pose), torch.from_numpy(vel))
    c = sphere_centers_world(tprob.robot, _collision_confs(tprob, ttraj.pose, ttraj.vel))
    dist, _, _, ok = sdf_lookup_points(tprob.sdf, c)
    active = ok & (dist <= tprob.robot.sphere_radii + tprob.eps)
    assert bool(active.any()) and bool((ok & ~active).any()) and bool((~ok).any())

    jtraj = JTrajectory(jnp.asarray(pose), jnp.asarray(vel))
    # jitted: the JAX package's eager nested vmap of jacfwd takes ~30 s here
    ref = jax.jit(jax.vmap(j_traj_linearize, in_axes=(axes, 0)))(jprob, jtraj)
    got = traj_linearize(tprob, ttraj)
    for name, g, r in zip(("H_diag", "H_off", "b", "err"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9, atol=1e-12 * np.abs(r).max(),
                                   err_msg=name)
    err_ref = jax.jit(jax.vmap(j_traj_error, in_axes=(axes, 0)))(jprob, jtraj)
    np.testing.assert_allclose(traj_error(tprob, ttraj).numpy(), np.asarray(err_ref),
                               rtol=1e-9)


def oracle_case():
    fx = np.load(FIXTURE, allow_pickle=True)
    occ = np.zeros((500, 500))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    sdf = planar_sdf_from_occupancy(fx["meta_origin"], float(fx["meta_cell"]), occ,
                                    dtype=F64, device=CPU)
    robot = make_robot_model(Pose2MobileBaseFK(), [(0, 0.25, (0.0, 0.0, 0.0))], dtype=F64,
                             device=CPU)
    setting = TrajOptimizerSetting(
        dof=3, total_step=int(fx["meta_n_steps"]), total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]), cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]), opt_type="lm", max_iter=100)
    kw = dict(flag_vehicle_dynamics=True, dyn_sigma=float(fx["meta_dyn_sigma"]))
    start = torch.as_tensor(fx["meta_start"], dtype=F64)
    end = torch.as_tensor(fx["meta_end"], dtype=F64)
    return fx, sdf, robot, setting, kw, start, end


def test_oracle_costs_and_init():
    fx, sdf, robot, setting, kw, start, end = oracle_case()
    z = torch.zeros(1, 3, dtype=F64)
    prob = make_problem(robot, sdf, start[None], z, end[None], z, setting, **kw)
    assert prob.planar and prob.flag_vehicle_dynamics and prob.space.kind == "se2"

    def err(pose_key, vel_key):
        traj = Trajectory(torch.as_tensor(fx[pose_key])[None],
                          torch.as_tensor(fx[vel_key])[None])
        return float(traj_error(prob, traj)[0])

    assert err("init_pose", "init_vel") == pytest.approx(float(fx["init_error"]), rel=1e-8)
    assert err("opt_pose", "opt_vel") == pytest.approx(float(fx["final_error"]), rel=1e-6)
    mine = init_traj_straight_line(robot.space, start, end, int(fx["meta_n_steps"]),
                                   float(fx["meta_total_time"]))
    np.testing.assert_allclose(mine.pose.numpy(), fx["init_pose"], atol=1e-12)
    np.testing.assert_allclose(mine.vel.numpy(), fx["init_vel"], atol=1e-12)


@pytest.mark.parametrize("opt_type,key", [("lm", "final_error"),
                                          ("dogleg", "dogleg_final_error"),
                                          ("gaussnewton", "gn_final_error")])
def test_oracle_optimizers(opt_type, key):
    """Each optimizer within 1% of the oracle's; the trust-region and GN
    fixtures were made at the fixture's tighter rel_tol."""
    fx, sdf, robot, setting, kw, start, end = oracle_case()
    setting.opt_type = opt_type
    if opt_type != "lm":
        setting.rel_thresh = float(fx["trust_rel_tol"])
        setting.max_iter = 200
    z = torch.zeros(3, dtype=F64)
    res = batch_traj_optimize(robot, sdf, start, z, end, z, setting, **kw)
    assert bool(res.converged) and not bool(res.gave_up)
    assert float(res.error) <= float(fx[key]) * 1.01 + 1e-9


def test_rescue_recovers_forced_gave_up_se2_lanes():
    """Forced gave-up SE(2) lanes are re-solved in float64 with their
    vehicle-dynamics weight and come back converged."""
    B = 6
    data, origin, cell = box_field()
    sdf = convert.planar_sdf_from_numpy(origin, cell, data, dtype=torch.float32, device=CPU)
    robot = generate_mobile_base(device=CPU)
    setting = TrajOptimizerSetting(dof=3, total_step=8, total_time=8.0, cost_sigma=0.1,
                                   obs_check_inter=2, opt_type="lm", Qc=np.eye(3))
    rng = np.random.default_rng(8)
    s = np.stack([np.full(B, -2.5), rng.uniform(-1.5, 1.5, B), rng.uniform(-0.5, 0.5, B)], -1)
    g = np.stack([np.full(B, 2.5), rng.uniform(-1.5, 1.5, B), rng.uniform(1.0, 2.0, B)], -1)
    s, g = (torch.as_tensor(x, dtype=torch.float32) for x in (s, g))
    zeros = torch.zeros(B, 3)
    probs = make_problem(robot, sdf, s, zeros, g, zeros, setting,
                         flag_vehicle_dynamics=True, dyn_sigma=0.01)
    init = init_traj_straight_line(probs.space, s, g, 8, 8.0)
    params = optimizer_params_from_setting(setting)
    res = plan_batch(probs, init, params)
    assert bool(res.converged.all())
    bad = torch.zeros(B, dtype=torch.bool)
    bad[[1, 4]] = True
    forced = OptResult(
        Trajectory(torch.where(bad[:, None, None], 1e3, res.traj.pose),
                   torch.where(bad[:, None, None], -1e3, res.traj.vel)),
        torch.where(bad, torch.inf, res.error), res.iterations, res.converged & ~bad, bad)
    rescued = _rescue_gave_up_f64(probs, init, params, forced)
    assert bool(rescued.converged[bad].all()) and not bool(rescued.gave_up[bad].any())
    assert rescued.traj.pose.dtype == torch.float32
    np.testing.assert_allclose(rescued.error[bad].numpy(), res.error[bad].numpy(), rtol=1e-3)
    assert torch.equal(rescued.traj.pose[~bad], res.traj.pose[~bad])


def test_vehicle_dynamics_needs_a_heading():
    """World-frame vehicle dynamics on a vector state read [x, y, theta]: a
    2-dof state has no heading and is refused."""
    data, origin, cell = box_field()
    sdf = convert.planar_sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU)
    robot = convert.point_robot_from_numpy(2, [0], [0.1], [[0.0, 0.0, 0.0]], dtype=F64,
                                           device=CPU)
    setting = TrajOptimizerSetting(dof=2, total_step=4, total_time=4.0, opt_type="lm")
    z = torch.zeros(1, 2, dtype=F64)
    with pytest.raises(ValueError, match="theta"):
        make_problem(robot, sdf, z, z, z + 1.0, z, setting, flag_vehicle_dynamics=True)

"""The port's bench_suite paths on the CPU, in float64: planar SDFs, the
point robot, joint and velocity limits, per-problem worlds, the float64
give-up rescue, and the entry points' default device.

- PointRobot2D and Arm3 (with joint limits) against the GTSAM-semantics
  oracle fixtures, as tests/test_parity_oracle.py does for the JAX
  package: the graph cost at the oracle's initial and optimized
  trajectories, and LM within 1% of the oracle's final cost. The port
  builds its SDFs with its own EDT and plans on the packed table.
- traj_linearize / traj_error against the JAX package's on identical
  problems (built from the JAX objects' leaves, utils/convert.py): the
  limits triple on the planar Arm3, and the point robot on per-problem
  worlds, at rtol 1e-9.
- MultiWorld2D: a batch of per-problem worlds against individual solves
  (tests/test_multiworld.py).
- The rescue: forced gave-up lanes come back converged
  (tests/test_rescue.py).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.kinematics import PointRobotFK as JPointRobotFK
from gpmp2_tpu.kinematics import make_robot_model as j_make_robot_model
from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
from gpmp2_tpu.planner.batch import infer_batch_axes
from gpmp2_tpu.planner.batch import make_problem as j_make_problem
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.planner.problem import traj_error as j_traj_error
from gpmp2_tpu.planner.problem import traj_linearize as j_traj_linearize
from gpmp2_tpu.planner.settings import TrajOptimizerSetting as JSetting
from gpmp2_tpu.robots import generate_arm as j_generate_arm
from gpmp2_tpu_torch.datasets import (generate_2d_dataset,
                                      planar_sdf_from_occupancy, sdf_from_occupancy)
from gpmp2_tpu_torch.kinematics.fk import PointRobotFK
from gpmp2_tpu_torch.kinematics.robot import make_robot_model
from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF
from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting,
                                     batch_traj_optimize, collision_cost,
                                     init_traj_straight_line, make_problem,
                                     optimizer_params_from_setting, plan_batch,
                                     traj_error, traj_linearize)
from gpmp2_tpu_torch.planner.batch import _rescue_gave_up_f64
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.solver.optimize import OptResult
from gpmp2_tpu_torch.utils import convert

F64 = torch.float64
CPU = "cpu"
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def load(name):
    return np.load(os.path.join(FIXDIR, f"oracle_{name}.npz"), allow_pickle=True)


def box_sdf(fx):
    """The oracle's 300 x 300 occupancy (one block) as the port's SDF."""
    occ = np.zeros((300, 300))
    r0, r1, c0, c1 = fx["meta_occ_box"]
    occ[r0:r1, c0:c1] = 1.0
    return planar_sdf_from_occupancy(fx["meta_origin"], float(fx["meta_cell"]), occ,
                                     dtype=F64, device=CPU)


def oracle_setting(fx, dof, **limits):
    return TrajOptimizerSetting(
        dof=dof, total_step=int(fx["meta_n_steps"]),
        total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]),
        cost_sigma=float(fx["meta_cost_sigma"]), epsilon=float(fx["meta_eps"]),
        opt_type="lm", max_iter=100, **limits)


def pointrobot_case():
    fx = load("pointrobot2d")
    robot = make_robot_model(PointRobotFK(), [(0, 0.15, (0.0, 0.0, 0.0))],
                             dtype=F64, device=CPU)
    return fx, robot, oracle_setting(fx, 2)


def arm3_case():
    fx = load("arm3_planar")
    setting = oracle_setting(
        fx, 3, flag_pos_limit=True, joint_pos_limits_down=fx["meta_lim_down"],
        joint_pos_limits_up=fx["meta_lim_up"], pos_limit_thresh=fx["meta_lim_thresh"],
        pos_limit_sigma=float(fx["meta_lim_sigma"]))
    return fx, generate_arm("SimpleThreeLinksArm", dtype=F64, device=CPU), setting


@pytest.mark.parametrize("case", [pointrobot_case, arm3_case], ids=["pointrobot2d", "arm3"])
def test_oracle_parity(case):
    fx, robot, setting = case()
    sdf = box_sdf(fx)
    d = robot.dof
    start = torch.as_tensor(fx["meta_start"], dtype=F64)
    end = torch.as_tensor(fx["meta_end"], dtype=F64)
    zeros = torch.zeros(d, dtype=F64)
    prob = make_problem(robot, sdf, start[None], zeros[None], end[None], zeros[None],
                        setting)
    assert prob.planar and prob.sdf.packed is not None

    def err(pose_key, vel_key):
        traj = Trajectory(torch.as_tensor(fx[pose_key])[None],
                          torch.as_tensor(fx[vel_key])[None])
        return float(traj_error(prob, traj)[0])

    assert err("init_pose", "init_vel") == pytest.approx(float(fx["init_error"]), rel=1e-8)
    assert err("opt_pose", "opt_vel") == pytest.approx(float(fx["final_error"]), rel=1e-6)

    res = batch_traj_optimize(robot, sdf, start, zeros, end, zeros, setting)
    assert bool(res.converged) and not bool(res.gave_up)
    assert float(res.error) <= float(fx["final_error"]) * 1.01 + 1e-9


def disc_worlds(centers, n=64):
    ys = -1.5 + 3.0 / (n - 1) * np.arange(n)
    X, Y = np.meshgrid(ys, ys)
    return np.stack([np.sqrt(X**2 + (Y - c) ** 2) - 0.3 for c in centers])


def jax_and_port(jrobot, jsdf, starts, goals, setting, port_robot):
    """A batched JAX problem, its vmap axes, and the port's problem built
    from its leaves."""
    zeros = np.zeros_like(starts)
    probs = j_make_problem(jrobot, jsdf, starts, zeros, goals, zeros, setting,
                           dtype=jnp.float64)
    one_world = jsdf._replace(data=jsdf.data[0], packed=None) if jsdf.data.ndim == 3 else jsdf
    template = j_make_problem(jrobot, one_world, starts[0], zeros[0], goals[0],
                              zeros[0], setting, dtype=jnp.float64)
    axes = infer_batch_axes(probs, template)
    s = probs.sdf
    assert s.packed is not None
    sdf = convert.planar_sdf_from_numpy(*(np.asarray(x) for x in (
        s.origin, s.cell_size, s.data, s.packed)), dtype=F64, device=CPU)
    arrays = {k: np.asarray(getattr(probs, k)) for k in convert.PROBLEM_ARRAYS}
    tprob = convert.problem_from_numpy(
        port_robot, sdf, probs.N, flag_pos_limit=probs.flag_pos_limit,
        flag_vel_limit=probs.flag_vel_limit, dtype=F64, device=CPU, **arrays)
    return probs, axes, tprob


@functools.lru_cache(maxsize=None)
def _arm3_limits():
    ds = generate_2d_dataset("OneObstacleDataset")
    field = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=F64,
                                      device=CPU).data.numpy()
    jsdf = JPlanarSDF(jnp.asarray(ds.origin), jnp.asarray(ds.cell_size), jnp.asarray(field))
    setting = JSetting(
        dof=3, total_step=6, total_time=3.0, cost_sigma=0.1, obs_check_inter=3,
        opt_type="lm", flag_pos_limit=True, flag_vel_limit=True,
        joint_pos_limits_down=-np.ones(3), joint_pos_limits_up=np.array([1.0, 0.8, 1.2]),
        vel_limits=np.array([0.3, 0.5, 0.4]), pos_limit_thresh=0.05)
    rng = np.random.default_rng(4)
    starts = 0.9 * rng.uniform(-1, 1, (3, 3))
    goals = np.array([1.5, 0.0, 0.0]) + 0.4 * rng.normal(size=(3, 3))
    jarm = j_generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
    f = jarm.fk
    port_robot = convert.robot_model_from_numpy(
        *(np.asarray(x) for x in (f.a, f.alpha, f.d, f.theta_bias, f.base_rot,
                                  f.base_trans, jarm.sphere_link_ids,
                                  jarm.sphere_radii, jarm.sphere_centers)),
        dtype=F64, device=CPU)
    return jax_and_port(jarm, jsdf, starts, goals, setting, port_robot)


@functools.lru_cache(maxsize=None)
def _point_worlds():
    B = 4
    data = disc_worlds([0.12, -0.2, 0.3, 0.001])
    jsdf = JPlanarSDF(jnp.asarray([-1.5, -1.5]), jnp.asarray(3.0 / 63), jnp.asarray(data))
    setting = JSetting(dof=2, total_step=8, total_time=4.0, obs_check_inter=2,
                       opt_type="lm", Qc=np.eye(2))
    rng = np.random.default_rng(5)
    starts = np.stack([np.full(B, -0.9), rng.uniform(-0.3, 0.3, B)], -1)
    goals = np.stack([np.full(B, 0.9), rng.uniform(-0.3, 0.3, B)], -1)
    jrobot = j_make_robot_model(JPointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))],
                                dtype=jnp.float64)
    port_robot = convert.point_robot_from_numpy(
        2, np.asarray(jrobot.sphere_link_ids), np.asarray(jrobot.sphere_radii),
        np.asarray(jrobot.sphere_centers), dtype=F64, device=CPU)
    return jax_and_port(jrobot, jsdf, starts, goals, setting, port_robot)


@pytest.mark.parametrize("case", [_arm3_limits, _point_worlds],
                         ids=["arm3_limits", "point_worlds"])
def test_linearize_matches_jax(case):
    jprob, axes, tprob = case()
    line = init_traj_straight_line(tprob.space, tprob.start_pose, tprob.end_pose,
                                   jprob.N, float(jprob.dt) * jprob.N)
    rng = np.random.default_rng(6)
    pose = line.pose.numpy() + 0.2 * rng.normal(size=line.pose.shape)
    vel = line.vel.numpy() + 0.3 * rng.normal(size=line.vel.shape)
    if tprob.flag_pos_limit:
        lo = tprob.pos_lim_down + tprob.pos_lim_thresh
        hi = tprob.pos_lim_up - tprob.pos_lim_thresh
        t = torch.from_numpy(pose)
        assert bool((t < lo).any()) and bool((t > hi).any())
        v = torch.from_numpy(vel)
        assert bool((v.abs() > tprob.vel_lim - tprob.vel_lim_thresh).any())
    jtraj = JTrajectory(jnp.asarray(pose), jnp.asarray(vel))
    ttraj = Trajectory(torch.from_numpy(pose), torch.from_numpy(vel))
    # jitted: the JAX package's eager vmap takes several times its compile
    ref = jax.jit(jax.vmap(j_traj_linearize, in_axes=(axes, 0)))(jprob, jtraj)
    got = traj_linearize(tprob, ttraj)
    for name, g, r in zip(("H_diag", "H_off", "b", "err"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                   atol=1e-12 * np.abs(r).max(), err_msg=name)
    err_ref = jax.jit(jax.vmap(j_traj_error, in_axes=(axes, 0)))(jprob, jtraj)
    np.testing.assert_allclose(traj_error(tprob, ttraj).numpy(), np.asarray(err_ref),
                               rtol=1e-9)


@pytest.mark.parametrize("packed", [True, False])
def test_planar_factor_error_matches_jax(packed):
    """The planar obstacle factor of the 3-link arm on the OneObstacle world."""
    from gpmp2_tpu.obstacle.factors import obstacle_planar_factor_error as j_error
    from gpmp2_tpu_torch.obstacle.factors import obstacle_planar_factor_error

    jprob, _, tprob = _arm3_limits()
    jsdf, tsdf = jprob.sdf, tprob.sdf
    if not packed:
        jsdf, tsdf = jsdf._replace(packed=None), dataclasses.replace(tsdf, packed=None)
    q = np.random.default_rng(8).uniform(-np.pi, np.pi, (64, 3))
    ref = jax.jit(jax.vmap(lambda c: j_error(jprob.robot, jsdf, c, 0.2)))(jnp.asarray(q))
    got = obstacle_planar_factor_error(tprob.robot, tsdf, torch.from_numpy(q),
                                       torch.tensor(0.2, dtype=F64))
    assert float(np.asarray(ref).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)


def test_multiworld_batched_matches_individual():
    B = 4
    data = disc_worlds([0.12, -0.2, 0.3, 0.001])
    sdf = PlanarSDF(torch.tensor([-1.5, -1.5], dtype=F64), torch.tensor(3.0 / 63, dtype=F64),
                    torch.from_numpy(data))
    robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))], dtype=F64,
                             device=CPU)
    setting = TrajOptimizerSetting(dof=2, total_step=8, total_time=4.0, obs_check_inter=2,
                                   opt_type="lm", max_iter=60, rel_thresh=1e-6, Qc=np.eye(2))
    starts = torch.tensor([[-0.9, 0.0]], dtype=F64).expand(B, 2)
    goals = torch.tensor([[0.9, 0.0]], dtype=F64).expand(B, 2)
    zeros = torch.zeros(B, 2, dtype=F64)
    params = optimizer_params_from_setting(setting)
    probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
    assert probs.sdf.num_worlds == B and probs.sdf.packed is not None
    init = init_traj_straight_line(probs.space, starts, goals, 8, 4.0)
    res = plan_batch(probs, init, params)
    for i in range(B):
        one = PlanarSDF(sdf.origin, sdf.cell_size, sdf.data[i])
        prob_i = make_problem(robot, one, starts[i:i + 1], zeros[:1], goals[i:i + 1],
                              zeros[:1], setting)
        res_i = plan_batch(prob_i, Trajectory(init.pose[i:i + 1], init.vel[i:i + 1]), params)
        np.testing.assert_allclose(res.traj.pose[i].numpy(), res_i.traj.pose[0].numpy(),
                                   atol=1e-8)
    # different worlds give different trajectories, each free in its own world
    assert float((res.traj.pose[0] - res.traj.pose[1]).abs().max()) > 0.05
    np.testing.assert_array_less(collision_cost(probs, res.traj.pose).numpy(), 1e-6)
    with pytest.raises(ValueError, match="worlds"):
        make_problem(robot, sdf, starts[:3], zeros[:3], goals[:3], zeros[:3], setting)


def rescue_setup(B=8):
    ds = generate_2d_dataset("OneObstacleDataset")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=CPU)
    robot = make_robot_model(PointRobotFK(), [(0, 0.08, (0.0, 0.0, 0.0))], device=CPU)
    setting = TrajOptimizerSetting(dof=2, total_step=10, total_time=10.0, cost_sigma=0.1,
                                   obs_check_inter=5, opt_type="lm", Qc=np.eye(2))
    rng = np.random.default_rng(3)
    s = np.stack([rng.uniform(-0.9, -0.5, B), rng.uniform(-0.9, 0.0, B)], -1)
    g = np.stack([rng.uniform(1.4, 1.8, B), rng.uniform(1.2, 1.8, B)], -1)
    s, g = (torch.as_tensor(x, dtype=torch.float32) for x in (s, g))
    zeros = torch.zeros(B, 2)
    probs = make_problem(robot, sdf, s, zeros, g, zeros, setting)
    init = init_traj_straight_line(probs.space, s, g, 10, 10.0)
    return probs, init, optimizer_params_from_setting(setting)


def test_rescue_recovers_forced_gave_up_lanes():
    probs, init, params = rescue_setup()
    res = plan_batch(probs, init, params)
    assert not bool(res.gave_up.any())
    same = plan_batch(probs, init, dataclasses.replace(params, rescue_f64=True))
    assert torch.equal(same.traj.pose, res.traj.pose) and torch.equal(same.error, res.error)

    bad = torch.zeros(res.error.shape[0], dtype=torch.bool)
    bad[[1, 4, 6]] = True
    forced = OptResult(
        Trajectory(torch.where(bad[:, None, None], 1e3, res.traj.pose),
                   torch.where(bad[:, None, None], -1e3, res.traj.vel)),
        torch.where(bad, torch.inf, res.error), res.iterations,
        res.converged & ~bad, bad)
    rescued = _rescue_gave_up_f64(probs, init, params, forced)
    assert bool(rescued.converged[bad].all()) and not bool(rescued.gave_up[bad].any())
    assert rescued.traj.pose.dtype == torch.float32
    # the float64 solve lands on the float32 solve's optimum
    np.testing.assert_allclose(rescued.error[bad].numpy(), res.error[bad].numpy(), rtol=1e-3)
    np.testing.assert_allclose(rescued.traj.pose[bad].numpy(), res.traj.pose[bad].numpy(),
                               atol=1e-2)
    # untouched lanes are bit-identical
    assert torch.equal(rescued.traj.pose[~bad], res.traj.pose[~bad])
    assert torch.equal(rescued.error[~bad], res.error[~bad])


ENTRY_POINTS = {
    "generate_arm": lambda: generate_arm("WAMArm"),
    "make_robot_model": lambda: make_robot_model(PointRobotFK(), [(0, 0.1, (0, 0, 0))]),
    "planar_sdf_from_occupancy": lambda: planar_sdf_from_occupancy(
        [0.0, 0.0], 0.1, np.eye(4)),
    "sdf_from_occupancy": lambda: sdf_from_occupancy(
        [0.0, 0.0, 0.0], 0.1, np.pad(np.ones((2, 2, 2)), 1)),
    "planar_sdf_from_numpy": lambda: convert.planar_sdf_from_numpy(
        [0.0, 0.0], 0.1, np.zeros((4, 4))),
    "make_problem": lambda: make_problem(
        make_robot_model(PointRobotFK(), [(0, 0.1, (0, 0, 0))], device=CPU),
        planar_sdf_from_occupancy([0.0, 0.0], 0.1, np.eye(4), device=CPU),
        np.zeros((1, 2)), np.zeros((1, 2)), np.ones((1, 2)), np.zeros((1, 2)),
        TrajOptimizerSetting(dof=2)),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Without a device, an entry point builds on CUDA: where there is no
    CUDA device it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()

"""The port's FactorGraph (planner/factor_graph.py) against the JAX
package's, float64 on the CPU.

- the structural errors: the same exceptions and messages as the JAX
  package's FactorGraph;
- `error` at rtol 1e-12 and `linearize` at atol 1e-9 against the JAX
  package's `linearize` (jitted; its err is the graph error), on graphs that together cover the
  whole factor inventory: the JAX package's own point-robot recipe
  (tests/test_factor_graph.py:32-65, the circle field); an Arm3 planar
  graph (K2's plain route); a 3-state WAM graph with one interpolated
  factor on a small 3D field; an SE(2) x R^2 graph with vehicle dynamics,
  joint and velocity limits, interpolated factors and an in-range
  obstacle; an SE(2) base with the Lie interpolation; goal and workspace
  factors; custom factors with full and diagonal precisions; and two
  factors on one state (two priors, an obstacle factor beside vector-state
  vehicle dynamics), the scatter that must accumulate;
- the port's graph against the port's traj_linearize and traj_error on
  the planner's recipe (the point robot, WAM, the SE(2) x R^2 arm with
  vehicle dynamics), and `optimize` against plan_batch at B = 1 (the
  point robot, WAM); `optimize`'s default parameters;
- `optimize` under LM, GN and Dogleg: iterations equal to the JAX
  package's and final error within rel 1e-6, on the point-robot recipe
  with endpoints off the diagonal through the disc's centre (on the
  diagonal the straight line meets the disc head on, a tie that rounding
  breaks either way).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.geometry.statespace import VectorSpace as JVectorSpace
from gpmp2_tpu.kinematics.fk import PointRobotFK as JPointRobotFK
from gpmp2_tpu.kinematics.robot import make_robot_model as j_make_robot_model
from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
from gpmp2_tpu.obstacle.sdf import SignedDistanceField as JSDF
from gpmp2_tpu.planner.factor_graph import FactorGraph as JFactorGraph
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.robots import generate_arm as j_generate_arm
from gpmp2_tpu.robots import generate_mobile_arm as j_generate_mobile_arm
from gpmp2_tpu.robots import generate_mobile_base as j_generate_mobile_base
from gpmp2_tpu.solver.optimize import OptimizerParams as JOptimizerParams
from gpmp2_tpu_torch.geometry.statespace import VectorSpace
from gpmp2_tpu_torch.kinematics.fk import PointRobotFK
from gpmp2_tpu_torch.kinematics.robot import make_robot_model
from gpmp2_tpu_torch.planner import (FactorGraph, Trajectory, TrajOptimizerSetting,
                                     init_traj_straight_line, make_problem, plan_batch,
                                     traj_error, traj_linearize)
from gpmp2_tpu_torch.planner import factor_graph
from gpmp2_tpu_torch.solver.optimize import OptimizerParams, OptResult
from gpmp2_tpu_torch.utils import convert
from test_factor_graph import circle_sdf_2d
from test_torch_linearize import CELL, ORIGIN, world_field
from test_torch_mobile_arm import planar_disc_field, port_robot

F64 = torch.float64
CPU = "cpu"
# placeholders in a graph's factor list, resolved per package
ROBOT, SDF, FK, RES1, RES2 = "robot", "sdf", "fk", "res1", "res2"


def port_arm(jrobot):
    """The port's RobotModel of a JAX DH arm, from its leaves."""
    fk = jrobot.fk
    return convert.robot_model_from_numpy(
        *(np.asarray(x) for x in (fk.a, fk.alpha, fk.d, fk.theta_bias, fk.base_rot,
                                  fk.base_trans, jrobot.sphere_link_ids, jrobot.sphere_radii,
                                  jrobot.sphere_centers)), dtype=F64, device=CPU)


def fields(origin, cell, data):
    """The JAX and port fields of one (origin, cell, data): 2D or 3D."""
    origin, data = np.asarray(origin, np.float64), np.asarray(data, np.float64)
    if origin.shape[0] == 2:
        return (JPlanarSDF(jnp.asarray(origin), jnp.asarray(cell), jnp.asarray(data)),
                convert.planar_sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU))
    return (JSDF(jnp.asarray(origin), jnp.asarray(cell), jnp.asarray(data)),
            convert.sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU))


def circle_fields():
    js = circle_sdf_2d()
    return fields(np.asarray(js.origin), float(js.cell_size), np.asarray(js.data))


def point_robot(r=0.05, dof=2):
    spheres = [(0, r, (0.0, 0.0, 0.0))]
    return (j_make_robot_model(JPointRobotFK(dof), spheres, dtype=jnp.float64),
            make_robot_model(PointRobotFK(dof), spheres, dtype=F64, device=CPU))


def recipe(N, total_time, inter, start, goal, sigma=1e-4, cost_sigma=0.1, eps=0.2, Qc=None):
    """The planner's factor list (BatchTrajOptimizer-inl.h:19-84), as the
    JAX package's tests/test_factor_graph.py builds it by hand."""
    d = len(start)
    Qc = np.eye(d) if Qc is None else Qc
    dt = total_time / N
    zero = np.zeros(d)
    out = [("prior_pose", (0, start, sigma)), ("prior_vel", (0, zero, sigma)),
           ("prior_pose", (N, goal, sigma)), ("prior_vel", (N, zero, sigma))]
    out += [("obstacle", (i, ROBOT, SDF, cost_sigma, eps)) for i in range(N + 1)]
    for i in range(N):
        out.append(("gp_prior", (i, i + 1, dt, Qc)))
        out += [("obstacle_gp", (i, i + 1, ROBOT, SDF, cost_sigma, eps, Qc, dt,
                                 j * dt / (inter + 1))) for j in range(1, inter + 1)]
    return out


def build(cls, space, n, factors, objs):
    """A graph of class `cls` with the factor list, placeholders resolved
    from `objs`."""
    g = cls(space, n)
    for name, args in factors:
        getattr(g, "add_" + name)(*(objs.get(a, a) if isinstance(a, str) else a
                                    for a in args))
    return g


def perturbed(space, start, goal, N, total_time, seed, scale=0.1):
    line = init_traj_straight_line(space, torch.as_tensor(start, dtype=F64),
                                   torch.as_tensor(goal, dtype=F64), N, total_time)
    rng = np.random.default_rng(seed)
    return (line.pose.numpy() + scale * rng.normal(size=line.pose.shape),
            line.vel.numpy() + scale * rng.normal(size=line.vel.shape))


# ---- the parity cases: (JAX graph, port graph, pose, vel) ------------------

def _case_point_robot():
    """tests/test_factor_graph.py's recipe and nudged straight line."""
    jr, r = point_robot()
    jsdf, sdf = circle_fields()
    start, goal = np.array([-1.5, -1.5]), np.array([1.5, 1.5])
    fs = recipe(6, 5.0, 3, start, goal)
    line = init_traj_straight_line(r.space, torch.tensor(start), torch.tensor(goal), 6, 5.0)
    rng = np.random.default_rng(0)
    pose = line.pose.numpy() + 0.11 * rng.normal(size=line.pose.shape)
    vel = line.vel.numpy() + 0.05 * rng.normal(size=line.vel.shape)
    return (build(JFactorGraph, jr.space, 7, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 7, fs, {ROBOT: r, SDF: sdf}), pose, vel)


def _disc_fields():
    return fields(*planar_disc_field())


def _case_arm3_planar():
    jr = j_generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
    r = port_arm(jr)
    jsdf, sdf = _disc_fields()
    start, goal = np.array([0.3, 0.2, -0.4]), np.array([1.4, -0.3, 0.5])
    fs = recipe(4, 2.0, 2, start, goal, sigma=1e-2)
    return (build(JFactorGraph, jr.space, 5, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 5, fs, {ROBOT: r, SDF: sdf}),
            *perturbed(r.space, start, goal, 4, 2.0, seed=1))


def _wam_fields():
    return fields(ORIGIN, CELL, world_field())


def _case_wam():
    jr = j_generate_arm("WAMArm", dtype=jnp.float64)
    r = port_arm(jr)
    jsdf, sdf = _wam_fields()
    start = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    goal = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    fs = recipe(2, 2.0, 1, start, goal, sigma=1e-2, cost_sigma=0.02)
    return (build(JFactorGraph, jr.space, 3, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 3, fs, {ROBOT: r, SDF: sdf}),
            *perturbed(r.space, start, goal, 2, 2.0, seed=2))


def _mobile_factors(N, d, start, goal, total_time, limits):
    """The recipe plus vehicle dynamics at every state and, with `limits`,
    joint and velocity limits, on an SE(2)-based state."""
    Qc = 0.8 * np.eye(d) + 0.1 * (np.ones((d, d)) - np.eye(d))
    fs = recipe(N, total_time, 2, start, goal, sigma=1e-2, Qc=Qc)
    fs += [("vehicle_dynamics", (i, 0.05)) for i in range(N + 1)]
    if limits:
        down, up = -0.2 * np.ones(d), 0.3 * np.ones(d)
        fs += [("joint_limit", (i, down, up, 1e-3, 0.01)) for i in range(N + 1)]
        fs += [("velocity_limit", (i, 0.4 * np.ones(d), 1e-3, 0.01)) for i in range(N + 1)]
    return fs


def _case_se2_vector():
    """SimpleTwoLinksArm on SE(2) x R^2 beside the disc, with vehicle
    dynamics, limits that bind and a non-diagonal Qc."""
    jr = j_generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64)
    r = port_robot(jr)
    jsdf, sdf = _disc_fields()
    start, goal = np.array([-0.6, -0.3, 0.2, 0.1, -0.3]), np.array([0.9, 0.5, 0.6, 0.4, 0.2])
    fs = _mobile_factors(3, 5, start, goal, 3.0, limits=True)
    return (build(JFactorGraph, jr.space, 4, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 4, fs, {ROBOT: r, SDF: sdf}),
            *perturbed(r.space, start, goal, 3, 3.0, seed=3, scale=0.15))


def _case_se2_base():
    jr = j_generate_mobile_base(dtype=jnp.float64)
    r = convert.mobile_base_from_numpy(*(np.asarray(x) for x in (
        jr.sphere_link_ids, jr.sphere_radii, jr.sphere_centers)), dtype=F64, device=CPU)
    jsdf, sdf = _disc_fields()
    start, goal = np.array([-0.5, -0.4, 0.3]), np.array([1.2, 0.6, 1.1])
    fs = _mobile_factors(3, 3, start, goal, 3.0, limits=False)
    return (build(JFactorGraph, jr.space, 4, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 4, fs, {ROBOT: r, SDF: sdf}),
            *perturbed(r.space, start, goal, 3, 3.0, seed=4, scale=0.15))


def _case_goal_workspace():
    """An Arm3 chain with the end-effector goal and the three workspace
    priors (two links, two states), no obstacles."""
    jr = j_generate_arm("SimpleThreeLinksArm", dtype=jnp.float64)
    r = port_arm(jr)
    start, goal = np.array([0.1, 0.2, 0.3]), np.array([0.9, -0.4, 0.6])
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    fs = [("prior_pose", (0, start, 1e-2)), ("prior_vel", (0, np.zeros(3), 1e-2)),
          ("gp_prior", (0, 1, 0.5, np.eye(3))), ("gp_prior", (1, 2, 0.5, np.eye(3))),
          ("goal", (2, FK, np.array([0.6, 1.1, 0.0]), 0.05)),
          ("workspace_position", (1, FK, 1, np.array([0.3, 0.6, 0.0]), 0.1)),
          ("workspace_orientation", (1, FK, 2, rot, 0.1)),
          ("workspace_pose", (2, FK, 1, rot.T, np.array([0.2, 0.5, 0.0]), [0.1, 0.1, 0.2,
                                                                          0.05, 0.05, 0.1]))]
    return (build(JFactorGraph, jr.space, 3, fs, {FK: jr.fk}),
            build(FactorGraph, r.space, 3, fs, {FK: r.fk}),
            *perturbed(r.space, start, goal, 2, 1.0, seed=5, scale=0.2))


def _custom_residuals(xp):
    """A unary and a binary user residual written with array module `xp`."""
    def unary(p, v):
        return xp.stack([xp.sin(p[0]) * v[1], p[0] * p[1] - 0.3])

    def binary(p1, v1, p2, v2):
        return xp.stack([p2[0] - p1[0] * xp.cos(v1[1]), (v2 - v1)[1] ** 2, p1[1] + p2[1]])
    return unary, binary


def _case_custom():
    jr, r = point_robot()
    start, goal = np.array([0.2, -0.4]), np.array([1.0, 0.7])
    W = np.array([[40.0, 5.0], [5.0, 20.0]])
    fs = [("prior_pose", (0, start, 1e-2)), ("prior_vel", (0, np.zeros(2), 1e-2)),
          ("gp_prior", (0, 1, 0.5, np.eye(2))), ("gp_prior", (1, 2, 0.5, np.eye(2))),
          ("custom", ((1,), RES1, W, 2)), ("custom", ((1, 2), RES2, [0.1, 0.2, 0.3], 3)),
          ("custom", ((0, 1), RES2, 0.5, 3))]
    ju, jb = _custom_residuals(jnp)
    u, b = _custom_residuals(torch)
    return (build(JFactorGraph, jr.space, 3, fs, {RES1: ju, RES2: jb}),
            build(FactorGraph, r.space, 3, fs, {RES1: u, RES2: b}),
            *perturbed(r.space, start, goal, 2, 1.0, seed=6, scale=0.2))


def _case_scatter():
    """Two factors on one state: two pose priors on state 0 and on state 2,
    and on every state an obstacle factor beside the vector-state vehicle
    dynamics (theta read from p[2]) of a 3-dof point robot."""
    jr, r = point_robot(r=0.3, dof=3)
    jsdf, sdf = _disc_fields()
    start, goal = np.array([-0.2, -0.1, 0.4]), np.array([1.1, 0.6, -0.3])
    fs = [("prior_pose", (0, start, 1e-2)), ("prior_pose", (0, start + 0.05, 0.1)),
          ("prior_vel", (0, np.zeros(3), 1e-2)), ("prior_pose", (2, goal, 1e-2)),
          ("prior_pose", (2, goal - 0.1, [0.1, 0.2, 0.3])),
          ("gp_prior", (0, 1, 0.5, np.eye(3))), ("gp_prior", (1, 2, 0.5, np.eye(3)))]
    for i in range(3):
        fs += [("obstacle", (i, ROBOT, SDF, 0.1, 0.2)), ("vehicle_dynamics", (i, 0.05))]
    return (build(JFactorGraph, jr.space, 3, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 3, fs, {ROBOT: r, SDF: sdf}),
            *perturbed(r.space, start, goal, 2, 1.0, seed=7, scale=0.2))


CASES = {"point_robot": _case_point_robot, "arm3_planar": _case_arm3_planar, "wam": _case_wam,
         "se2_vector": _case_se2_vector, "se2_base": _case_se2_base,
         "goal_workspace": _case_goal_workspace, "custom": _case_custom,
         "scatter": _case_scatter}


def _obstacle_error(g, traj):
    """The error of the graph's obstacle factors alone."""
    sub = FactorGraph(g.space, g.n)
    sub.factors = [f for f in g.factors if f.name.startswith("obstacle")]
    return float(sub.error(traj))


@pytest.mark.parametrize("case", list(CASES))
def test_graph_matches_jax(case):
    jg, g, pose, vel = CASES[case]()
    traj = Trajectory(torch.from_numpy(pose), torch.from_numpy(vel))
    jtraj = JTrajectory(jnp.asarray(pose), jnp.asarray(vel))
    if any(f.name.startswith("obstacle") for f in g.factors):
        assert _obstacle_error(g, traj) > 0  # some hinge is active
    # the JAX graph's error is its linearize's err (the same residuals):
    # one compile
    ref = jax.jit(jg.linearize)(jtraj)
    np.testing.assert_allclose(float(g.error(traj)), float(ref[3]), rtol=1e-12)
    got = g.linearize(traj)
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=1e-12)
    for name, a, b in zip(("H_diag", "H_off", "b"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9, err_msg=name)


# ---- the port's graph against the port's planner ------------------------------

def _planner_recipe(name):
    """(graph, problems of B = 1, trajectory) of one recipe in the port."""
    if name == "point_robot":
        _, r = point_robot()
        sdf = circle_fields()[1]
        start, goal, N, T, inter, kw = [-1.5, -1.2], [1.5, 1.3], 6, 5.0, 3, {}
        setting = TrajOptimizerSetting(dof=2, total_step=N, total_time=T, epsilon=0.2,
                                       cost_sigma=0.1, obs_check_inter=inter)
        extra = []
    elif name == "wam":
        r = port_arm(j_generate_arm("WAMArm", dtype=jnp.float64))
        sdf = _wam_fields()[1]
        start = [-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2]
        goal = [-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55]
        N, T, inter, kw = 3, 2.0, 2, {}
        setting = TrajOptimizerSetting(dof=7, total_step=N, total_time=T, epsilon=0.2,
                                       cost_sigma=0.02, obs_check_inter=inter)
        extra = []
    else:  # the SE(2) x R^2 arm with vehicle dynamics
        r = port_robot(j_generate_mobile_arm("SimpleTwoLinksArm", dtype=jnp.float64))
        sdf = _disc_fields()[1]
        start, goal = [-0.6, -0.3, 0.2, 0.1, -0.3], [0.9, 0.5, 0.6, 0.4, 0.2]
        N, T, inter = 3, 3.0, 2
        kw = dict(flag_vehicle_dynamics=True, dyn_sigma=0.05)
        # the boundary priors' pose Jacobian is the planner's SE(2) block
        # beside I and the graph's jacfwd over the whole state, equal to
        # an ulp; at the default sigma 1e-4 an ulp of J^T W J is 1.5e-8,
        # above the atol, so this recipe's priors take sigma 1e-3
        setting = TrajOptimizerSetting(dof=5, total_step=N, total_time=T, epsilon=0.2,
                                       cost_sigma=0.1, obs_check_inter=inter,
                                       conf_prior_sigma=1e-3, vel_prior_sigma=1e-3)
        extra = [("vehicle_dynamics", (i, 0.05)) for i in range(N + 1)]
    start, goal = np.asarray(start), np.asarray(goal)
    fs = recipe(N, T, inter, start, goal, sigma=setting.conf_prior_sigma,
                cost_sigma=setting.cost_sigma, eps=setting.epsilon) + extra
    # in the planner's order: priors, GP priors, obstacle factors, the
    # interpolated ones, vehicle dynamics (the sums into the 1e8 prior
    # entries then round alike)
    order = ("prior_pose", "prior_vel", "gp_prior", "obstacle", "obstacle_gp",
             "vehicle_dynamics")
    fs = sorted(fs, key=lambda f: order.index(f[0]))
    g = build(FactorGraph, r.space, N + 1, fs, {ROBOT: r, SDF: sdf})
    s, e = (torch.as_tensor(x, dtype=F64)[None] for x in (start, goal))
    z = torch.zeros_like(s)
    probs = make_problem(r, sdf, s, z, e, z, setting, sdf_pack=False, **kw)
    pose, vel = perturbed(r.space, start, goal, N, T, seed=8, scale=0.1)
    return g, probs, Trajectory(torch.from_numpy(pose), torch.from_numpy(vel))


@pytest.mark.parametrize("name", ["point_robot", "wam", "se2_vector"])
def test_graph_matches_planner(name):
    g, probs, traj = _planner_recipe(name)
    batched = Trajectory(traj.pose[None], traj.vel[None])
    np.testing.assert_allclose(float(g.error(traj)), float(traj_error(probs, batched)[0]),
                               rtol=1e-12)
    got, ref = g.linearize(traj), traj_linearize(probs, batched)
    np.testing.assert_allclose(float(got[3]), float(ref[3][0]), rtol=1e-12)
    for part, a, b in zip(("H_diag", "H_off", "b"), got, ref):
        np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=0, atol=1e-9, err_msg=part)


@pytest.mark.parametrize("name", ["point_robot", "wam"])
def test_graph_optimize_matches_plan_batch(name):
    """The graph's optimize is plan_batch's loop at B = 1."""
    g, probs, traj = _planner_recipe(name)
    batched = Trajectory(traj.pose[None], traj.vel[None])
    params = OptimizerParams(method="lm", max_iter=30, rel_thresh=1e-4)
    res = g.optimize(traj, params)
    ref = plan_batch(probs, batched, params)
    assert int(res.iterations) == int(ref.iterations[0])
    np.testing.assert_allclose(float(res.error), float(ref.error[0]), rtol=1e-9)


# ---- optimize against the JAX package -------------------------------------------

@functools.lru_cache(maxsize=None)
def _optimize_graphs():
    jr, r = point_robot()
    jsdf, sdf = circle_fields()
    start, goal = np.array([-1.5, -1.2]), np.array([1.5, 1.3])
    fs = recipe(6, 5.0, 3, start, goal)
    line = init_traj_straight_line(r.space, torch.tensor(start), torch.tensor(goal), 6, 5.0)
    return (build(JFactorGraph, jr.space, 7, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 7, fs, {ROBOT: r, SDF: sdf}), line)


@pytest.mark.parametrize("method", ["lm", "gaussnewton", "dogleg"])
def test_optimize_matches_jax(method):
    jg, g, line = _optimize_graphs()
    res = g.optimize(line, OptimizerParams(method=method, max_iter=60, rel_thresh=1e-5))
    ref = jg.optimize(JTrajectory(jnp.asarray(line.pose.numpy()), jnp.asarray(line.vel.numpy())),
                      JOptimizerParams(method=method, max_iter=60, rel_thresh=1e-5))
    assert int(res.iterations) == int(ref.iterations)
    assert bool(res.converged) == bool(ref.converged)
    np.testing.assert_allclose(float(res.error), float(ref.error), rtol=1e-6)
    assert float(res.error) < float(g.error(line))


def test_optimize_defaults_to_gauss_newton(monkeypatch):
    """No params: GN, max_iter 100, rel_thresh 1e-5, as the JAX package."""
    seen = []

    def spy(lin, retract, traj0, params):
        seen.append(params)
        return OptResult(traj0, *(torch.zeros(1) for _ in range(4)))

    monkeypatch.setattr(factor_graph, "optimize_batch", spy)
    g = FactorGraph(VectorSpace(2), 2).add_prior_pose(0, np.zeros(2), 1.0)
    g.optimize(Trajectory(torch.zeros(2, 2, dtype=F64), torch.zeros(2, 2, dtype=F64)))
    assert seen == [OptimizerParams(method="gaussnewton", max_iter=100, rel_thresh=1e-5)]


# ---- structural errors -------------------------------------------------------------

def _raise_of(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


STRUCTURE = {
    "nonadjacent": lambda cls, sp: cls(sp, 5).add_gp_prior(0, 2, 0.5, np.eye(2)),
    "out_of_range": lambda cls, sp: cls(sp, 5).add_prior_pose(7, np.zeros(2), 1e-4),
    "negative": lambda cls, sp: cls(sp, 5).add_prior_vel(-1, np.zeros(2), 1e-4),
    "custom_arity": lambda cls, sp: cls(sp, 5).add_custom((0, 1, 2), None, 1.0, 1),
    "custom_nonadjacent": lambda cls, sp: cls(sp, 5).add_custom((1, 3), None, 1.0, 1),
    "sigma_length": lambda cls, sp: cls(sp, 5).add_prior_pose(0, np.zeros(2), [1.0, 2.0, 3.0]),
    "no_states": lambda cls, sp: cls(sp, 0),
}


@pytest.mark.parametrize("case", list(STRUCTURE))
def test_structural_errors_match_jax(case):
    make = STRUCTURE[case]
    assert (_raise_of(lambda: make(FactorGraph, VectorSpace(2)))
            == _raise_of(lambda: make(JFactorGraph, JVectorSpace(2))))


def test_graph_rejects_wrong_trajectory_shape():
    g = FactorGraph(VectorSpace(2), 4).add_prior_pose(0, np.zeros(2), 1.0)
    with pytest.raises(ValueError, match="4 states of dim 2"):
        g.error(Trajectory(torch.zeros(3, 2, dtype=F64), torch.zeros(3, 2, dtype=F64)))

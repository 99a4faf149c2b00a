"""Port's traj_linearize / traj_error vs the JAX package, float64 on the CPU.

The world is a small synthetic 60^3 SDF with two boxes near the WAM's
workspace, on a dyadic grid (cell 1/32 m) so that chosen points land on
grid nodes and grid edges exactly. The JAX problems are built with
`sdf_pack=False`, so both packages read the same unpacked field, and the
port's objects are built from the JAX objects' leaves (utils/convert.py).
The port's obstacle Jacobian is -g . J from explicit sphere Jacobians; the
JAX default is the triple product: the difference is reassociation only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.geometry.se3 import Pose3 as JPose3
from gpmp2_tpu.kinematics.fk import ArmFK as JArmFK
from gpmp2_tpu.kinematics.robot import make_robot_model as j_make_robot_model
from gpmp2_tpu.obstacle.factors import hinge_loss as j_hinge_loss
from gpmp2_tpu.obstacle.sdf import SignedDistanceField as JSDF
from gpmp2_tpu.obstacle.sdf import sdf_lookup_components as j_lookup
from gpmp2_tpu.planner.batch import infer_batch_axes
from gpmp2_tpu.planner.batch import make_problem as j_make_problem
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.planner.problem import traj_error as j_traj_error
from gpmp2_tpu.planner.problem import traj_linearize as j_traj_linearize
from gpmp2_tpu.planner.settings import TrajOptimizerSetting
from gpmp2_tpu.robots import generate_arm as j_generate_arm
from gpmp2_tpu_torch.datasets.generate3d import add_obstacle_3d
from gpmp2_tpu_torch.datasets.sdf_gen import signed_distance_field_3d
from gpmp2_tpu_torch.kinematics.robot import sphere_centers_world
from gpmp2_tpu_torch.obstacle.factors import hinge_loss
from gpmp2_tpu_torch.obstacle.sdf import sdf_lookup_components
from gpmp2_tpu_torch.planner.problem import (Trajectory, _collision_confs,
                                             traj_error, traj_linearize)
from gpmp2_tpu_torch.planner.traj_utils import init_traj_straight_line
from gpmp2_tpu_torch.utils.convert import (PROBLEM_ARRAYS, problem_from_numpy,
                                           robot_model_from_numpy,
                                           sdf_from_numpy)

F64 = jnp.float64
CELL = 1.0 / 32
ORIGIN = np.array([-0.625, -0.875, -1.0])  # (z, y, x) node NODE is (0.25, 0, 0)
NODE = (32, 28, 28)
BASE_START = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
BASE_GOAL = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])


@functools.lru_cache(maxsize=None)
def _world_field():
    occ = np.zeros((60, 60, 60))
    occ, _ = add_obstacle_3d([30, 44, 51], [10, 6, 10], occ)
    occ, _ = add_obstacle_3d([40, 26, 44], [6, 6, 14], occ)
    return np.ascontiguousarray(
        np.transpose(signed_distance_field_3d(occ, CELL), (2, 1, 0)))


def world_field():
    """(Z, Y, X) SDF of two boxes beside the WAM's straight-line paths (a
    fresh copy of the one computed per process)."""
    return _world_field().copy()


def wam_setting(total_step=5, inter=3, opt_type="lm", dof=7):
    return TrajOptimizerSetting(
        dof=dof, total_step=total_step, total_time=2.0, epsilon=0.2,
        cost_sigma=0.02, obs_check_inter=inter, opt_type=opt_type,
        max_iter=50, rel_thresh=1e-2)


def wam_endpoints(B, seed):
    rng = np.random.default_rng(seed)
    return (BASE_START + 0.05 * rng.normal(size=(B, 7)),
            BASE_GOAL + 0.05 * rng.normal(size=(B, 7)))


def jax_problem(jrobot, field, starts, goals, setting):
    """Batched JAX problem (start/goal leading axis) and its vmap axes."""
    jsdf = JSDF(jnp.asarray(ORIGIN, F64), jnp.asarray(CELL, F64),
                jnp.asarray(field, F64))
    zeros = np.zeros_like(starts)
    kw = dict(dtype=F64, sdf_pack=False)
    probs = j_make_problem(jrobot, jsdf, starts, zeros, goals, zeros, setting, **kw)
    template = j_make_problem(jrobot, jsdf, starts[0], zeros[0], goals[0],
                              zeros[0], setting, **kw)
    return probs, infer_batch_axes(probs, template)


def port_problem(jprob, dtype=torch.float64):
    """The port's problem, built from the JAX problem's leaves."""
    r, fk = jprob.robot, jprob.robot.fk
    robot = robot_model_from_numpy(
        *(np.asarray(x) for x in (fk.a, fk.alpha, fk.d, fk.theta_bias,
                                  fk.base_rot, fk.base_trans, r.sphere_link_ids,
                                  r.sphere_radii, r.sphere_centers)),
        dtype=dtype, device="cpu")
    sdf = sdf_from_numpy(np.asarray(jprob.sdf.origin),
                         np.asarray(jprob.sdf.cell_size),
                         np.asarray(jprob.sdf.data), dtype=dtype, device="cpu")
    arrays = {k: np.asarray(getattr(jprob, k)) for k in PROBLEM_ARRAYS}
    return problem_from_numpy(robot, sdf, jprob.N, dtype=dtype, device="cpu",
                              **arrays)


def edge_arm():
    """Planar 2-link arm (a = 1/4, 1/4) whose spheres at q = 0 sit exactly:
    sphere 0 on grid node NODE, where the field is set to its hinge
    threshold (dist == eps_total, an active hinge with zero residual);
    sphere 1 on the grid's top x face (in range, low corner clamped to
    size - 2); sphere 2 above the grid (out of range); sphere 3 inside."""
    fk = JArmFK.create(a=[0.25, 0.25], alpha=[0.0, 0.0], d=[0.0, 0.0],
                       base_pose=JPose3(jnp.eye(3, dtype=F64), jnp.zeros(3, F64)),
                       dtype=F64)
    x_top = ORIGIN[0] + 59 * CELL  # world x of the top face
    return j_make_robot_model(
        fk, [(0, 0.05, (0.0, 0.0, 0.0)), (1, 0.05, (x_top - 0.5, 0.0, 0.0)),
             (1, 0.05, (0.0, 0.0, 1.0)), (1, 0.05, (0.0, 0.1, 0.05))],
        dtype=F64)


def _case_wam():
    B = 3
    starts, goals = wam_endpoints(B, seed=0)
    jprob, axes = jax_problem(j_generate_arm("WAMArm", dtype=F64), world_field(),
                              starts, goals, wam_setting())
    rng = np.random.default_rng(1)
    line = init_traj_straight_line(port_problem(jprob).space,
                                   torch.from_numpy(starts), torch.from_numpy(goals), 5, 2.0)
    pose = line.pose.numpy() + 0.1 * rng.normal(size=line.pose.shape)
    vel = line.vel.numpy() + 0.1 * rng.normal(size=line.vel.shape)
    return jprob, axes, pose, vel


def _case_edges():
    jrobot = edge_arm()
    field = world_field()
    eps_total = np.float64(0.05) + np.float64(0.2)  # radius + epsilon, as both packages add
    field[NODE] = eps_total
    setting = wam_setting(dof=2)
    starts = np.zeros((2, 2))
    goals = np.array([[0.0, 0.0], [0.3, -0.2]])
    jprob, axes = jax_problem(jrobot, field, starts, goals, setting)
    # lane 0 rests at q = 0 (every collision state exactly on the edges);
    # lane 1 is generic
    pose = np.zeros((2, 6, 2))
    pose[1] = np.linspace(0.0, 1.0, 6)[:, None] * goals[1]
    vel = np.zeros((2, 6, 2))
    vel[1] = goals[1] / 2.0
    return jprob, axes, pose, vel


CASES = {"wam": _case_wam, "edges": _case_edges}


def _hinge_states(tprob, pose, vel):
    """Counts of (active, inactive in range, out of range) sphere queries."""
    confs = _collision_confs(tprob, torch.from_numpy(pose), torch.from_numpy(vel))
    c = sphere_centers_world(tprob.robot, confs)
    dist, _, _, _, ok = sdf_lookup_components(tprob.sdf, c[..., 0], c[..., 1], c[..., 2])
    active = ok & (dist <= tprob.robot.sphere_radii + tprob.eps)
    return int(active.sum()), int((ok & ~active).sum()), int((~ok).sum()), dist


@pytest.mark.parametrize("case", list(CASES))
def test_linearize_matches_jax(case):
    jprob, axes, pose, vel = CASES[case]()
    tprob = port_problem(jprob)
    n_active, n_free, n_out, dist = _hinge_states(tprob, pose, vel)
    assert n_active > 0 and n_free > 0 and n_out > 0
    if case == "edges":
        eps_total = (tprob.robot.sphere_radii + tprob.eps)[0]
        assert bool((dist[0, :, 0] == eps_total).all())

    # jitted: the JAX package's eager vmap takes several times its compile
    ref = jax.jit(jax.vmap(j_traj_linearize, in_axes=(axes, 0)))(
        jprob, JTrajectory(jnp.asarray(pose), jnp.asarray(vel)))
    got = traj_linearize(tprob, Trajectory(torch.from_numpy(pose), torch.from_numpy(vel)))
    for name, g, r in zip(("H_diag", "H_off", "b", "err"), got, ref):
        r = np.asarray(r)
        # entries near zero after cancellation get an absolute floor at the
        # array's own scale
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-9,
                                   atol=1e-12 * np.abs(r).max(), err_msg=name)

    err_ref = jax.jit(jax.vmap(j_traj_error, in_axes=(axes, 0)))(
        jprob, JTrajectory(jnp.asarray(pose), jnp.asarray(vel)))
    err = traj_error(tprob, Trajectory(torch.from_numpy(pose), torch.from_numpy(vel)))
    np.testing.assert_allclose(err.numpy(), np.asarray(err_ref), rtol=1e-9)


def test_sdf_edges_match_jax():
    """Lookups exactly on the grid's faces, just outside, and at NaN:
    identical distances, gradients and in-range masks, and a hinge that
    is active at dist == eps_total."""
    field = world_field()
    top = ORIGIN + 59 * CELL
    pts = np.array([
        ORIGIN, top, [top[0], 0.0, 0.0], [ORIGIN[0], 0.1, -0.2],
        [top[0] + 1e-9, 0.0, 0.0], [ORIGIN[0] - 1e-9, 0.0, 0.0],
        [0.25, 0.0, 0.0], [np.nan, 0.0, 0.0], [0.1, np.nan, 0.3],
    ])
    jsdf = JSDF(jnp.asarray(ORIGIN), jnp.asarray(CELL), jnp.asarray(field))
    tsdf = sdf_from_numpy(ORIGIN, CELL, field, dtype=torch.float64, device="cpu")
    ref = j_lookup(jsdf, *(jnp.asarray(pts[:, k]) for k in range(3)))
    got = sdf_lookup_components(tsdf, *(torch.from_numpy(pts[:, k]) for k in range(3)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-15)
    assert np.asarray(ref[-1]).tolist() == [True, True, True, True,
                                            False, False, True, False, False]

    eps = np.asarray(ref[0])[6]
    dist = np.array([eps, eps - 0.1, eps + 0.1, np.nan])
    ok = np.array([True, True, True, False])
    np.testing.assert_array_equal(
        hinge_loss(torch.from_numpy(dist), torch.tensor(eps), torch.from_numpy(ok)).numpy(),
        np.asarray(j_hinge_loss(jnp.asarray(dist), eps, jnp.asarray(ok))))

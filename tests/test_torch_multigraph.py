"""The port's multi-chain planner graphs (planner/multigraph.py) against the
JAX package's, float64 on the CPU.

- `build_planner_graph`: nodes and edges identical, with and without the
  seeded random inter-chain edges;
- `sample_initializations`: the port's draw from JAX's own z (redrawn
  from its key here) equal to JAX's samples at 1e-10, and the port's
  generator-driven draw seeded, pinned at both ends and near the line;
- on the example's graph (MultiObstacleDataset, the point robot of radius
  1.5, four chains drawn from the GP posterior): `multigraph_error` and
  `edge_costs` at rtol 1e-10, the dense whitened Jacobian against JAX's
  jax.jacfwd, `optimize_multigraph` (final error at rel 1e-6, accepted
  steps and convergence equal) and `shortest_path` equal; the same on an
  SE(2) base's graph (the Lie prior, GP and interpolation Jacobians);
- the Dijkstra on a diamond, and the `nvar > 2048` warning.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.geometry.statespace import StateSpace as JStateSpace
from gpmp2_tpu.kinematics.fk import PointRobotFK as JPointRobotFK
from gpmp2_tpu.kinematics.robot import make_robot_model as j_make_robot_model
from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
from gpmp2_tpu.planner import multigraph as jmg
from gpmp2_tpu.robots import generate_mobile_base as j_generate_mobile_base
from gpmp2_tpu_torch.datasets import generate_2d_dataset
from gpmp2_tpu_torch.geometry.statespace import SE2Space, VectorSpace
from gpmp2_tpu_torch.kinematics.fk import PointRobotFK
from gpmp2_tpu_torch.kinematics.robot import make_robot_model
from gpmp2_tpu_torch.planner import multigraph as mg
from gpmp2_tpu_torch.planner.multigraph import _whitened_system
from gpmp2_tpu_torch.robots import generate_mobile_base
from gpmp2_tpu_torch.utils import convert
from test_torch_mobile_arm import planar_disc_field

F64 = torch.float64
CPU = "cpu"
START, GOAL = np.array([0.0, 0.0]), np.array([17.0, 14.0])


@functools.lru_cache(maxsize=None)
def _multi_obstacle_field():
    from gpmp2_tpu_torch.datasets import signed_distance_field_2d

    ds = generate_2d_dataset("MultiObstacleDataset")
    return (np.asarray(ds.origin, np.float64), float(ds.cell_size),
            signed_distance_field_2d(ds.map, ds.cell_size))


def _fields(origin, cell, data):
    return (JPlanarSDF(jnp.asarray(origin), jnp.asarray(cell), jnp.asarray(data)),
            convert.planar_sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU))


def _jax_chains(n_steps, n_chains, seed):
    return np.asarray(jmg.sample_initializations(
        JStateSpace("vector", 2), jnp.asarray(START), jnp.asarray(GOAL), n_steps,
        float(n_steps), np.eye(2), n_chains, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("connect_prob,seed", [(0.0, None), (0.5, 7), (0.9, 3)])
def test_build_planner_graph_matches_jax(connect_prob, seed):
    chains = np.random.default_rng(0).normal(size=(3, 8, 2))
    got = mg.build_planner_graph(torch.from_numpy(chains), [0.5, -0.2], connect_prob, seed)
    ref = jmg.build_planner_graph(chains, [0.5, -0.2], connect_prob, seed)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sample_initializations_matches_jax():
    n_steps, n_chains, seed = 10, 6, 0
    ref = _jax_chains(n_steps, n_chains, seed)
    z = jax.random.normal(jax.random.PRNGKey(seed), (n_chains, (n_steps + 1) * 4), jnp.float64)
    start, goal = torch.from_numpy(START), torch.from_numpy(GOAL)
    mean, H = mg.chain_posterior(VectorSpace(2), start, goal, n_steps, float(n_steps), np.eye(2))
    got = mg.posterior_draw(mean, H, torch.from_numpy(np.array(z)), start, goal, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)


def test_sample_initializations_seeded():
    start, goal = torch.from_numpy(START), torch.from_numpy(GOAL)
    draw = [mg.sample_initializations(VectorSpace(2), start, goal, 10, 10.0, np.eye(2), 6,
                                      torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert draw[0].shape == (6, 11, 2)
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert bool((draw[0][:, 0] == start).all()) and bool((draw[0][:, -1] == goal).all())
    assert float(draw[0][:, 5, 0].std()) > 0.01
    assert float((draw[0][:, 5].mean(0) - 0.5 * (start + goal)).norm()) < 5.0
    with pytest.raises(ValueError, match="vector space"):
        mg.chain_posterior(SE2Space(), torch.zeros(3, dtype=F64), torch.ones(3, dtype=F64),
                           4, 4.0, np.eye(3))


def _point_graph():
    """The example's graph at 10 steps: four chains from JAX's posterior,
    random inter-chain edges, the point robot of radius 1.5."""
    chains = _jax_chains(10, 4, 1)
    pose0, vel0, edges = jmg.build_planner_graph(chains, (GOAL - START) / 10.0, 0.5, 1)
    spheres = [(0, 1.5, (0.0, 0.0, 0.0))]
    jrobot = j_make_robot_model(JPointRobotFK(), spheres, dtype=jnp.float64)
    robot = make_robot_model(PointRobotFK(), spheres, dtype=F64, device=CPU)
    return (jrobot, robot, _fields(*_multi_obstacle_field()), edges, START, GOAL, pose0, vel0,
            dict(dt=1.0, Qc=np.eye(2), cost_sigma=0.5, epsilon=4.0, obs_check_inter=1))


def _se2_graph():
    """Two hand-made SE(2) chains of 4 steps beside the disc, random
    inter-chain edges, the mobile base; no node lies on a grid line of the
    field, where the lookup's gradient jumps."""
    s, g = np.array([-1.013, -0.817, 0.2]), np.array([1.187, 0.913, 1.0])
    t = np.linspace(0.0, 1.0, 5)[:, None]
    line = s * (1 - t) + g * t
    chains = np.stack([line + [0.0, 0.25, 0.1] * np.sin(np.pi * t),
                       line - [0.1, 0.3, 0.2] * np.sin(np.pi * t)])
    pose0, vel0, edges = jmg.build_planner_graph(chains, (g - s) / 4.0, 0.6, 2)
    jrobot = j_generate_mobile_base(dtype=jnp.float64)
    robot = generate_mobile_base(dtype=F64, device=CPU)
    return (jrobot, robot, _fields(*planar_disc_field()), edges, s, g, pose0, vel0,
            dict(dt=1.0, Qc=0.5 * np.eye(3), cost_sigma=0.2, epsilon=0.3, obs_check_inter=2))


GRAPHS = {"point_robot": _point_graph, "se2_base": _se2_graph}


@functools.lru_cache(maxsize=None)
def _problems(name):
    jrobot, robot, (jsdf, sdf), edges, s, g, pose0, vel0, kw = GRAPHS[name]()
    z = np.zeros_like(s)
    jprob = jmg.make_multigraph_problem(jrobot, jsdf, edges, s, z, g, z, dtype=jnp.float64, **kw)
    prob = mg.make_multigraph_problem(robot, sdf, edges, torch.from_numpy(s),
                                      torch.from_numpy(z), torch.from_numpy(g),
                                      torch.from_numpy(z), dtype=F64, **kw)
    return jprob, prob, pose0, vel0


@pytest.mark.parametrize("name", list(GRAPHS))
def test_error_and_edge_costs_match_jax(name):
    jprob, prob, pose0, vel0 = _problems(name)
    P, V = torch.from_numpy(pose0), torch.from_numpy(vel0)

    def jax_refs(p, v):
        res_fn = jmg._flat_residual_fn(jprob, p, v)
        z0 = jnp.zeros(p.size * 2)
        return (jmg.multigraph_error(jprob, p, v), jmg.edge_costs(jprob, p, v), res_fn(z0),
                jax.jacfwd(res_fn)(z0))

    ref_err, ref_costs, ref_r, ref_J = jax.jit(jax_refs)(jnp.asarray(pose0), jnp.asarray(vel0))
    assert float(ref_err) > 0
    np.testing.assert_allclose(float(mg.multigraph_error(prob, P, V)), float(ref_err),
                               rtol=1e-10)
    for a, b in zip(mg.edge_costs(prob, P, V), ref_costs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
        assert float(a.abs().max()) > 0
    # the dense whitened system against jax.jacfwd of the flat residual
    r, J = _whitened_system(prob, P, V)
    np.testing.assert_allclose(r.numpy(), np.asarray(ref_r), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(J.numpy(), np.asarray(ref_J), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_optimize_and_path_match_jax(name):
    jprob, prob, pose0, vel0 = _problems(name)
    got = mg.optimize_multigraph(prob, torch.from_numpy(pose0), torch.from_numpy(vel0))
    ref = jax.jit(jmg.optimize_multigraph)(jprob, jnp.asarray(pose0), jnp.asarray(vel0))
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6)
    assert int(got[3]) == int(ref[3]) and int(got[3]) >= 1
    assert bool(got[4]) == bool(ref[4])
    assert float(got[2]) < float(mg.multigraph_error(prob, torch.from_numpy(pose0),
                                                     torch.from_numpy(vel0)))
    path = mg.shortest_path(prob.edges, *mg.edge_costs(prob, got[0], got[1]))
    ref_costs = jax.jit(jmg.edge_costs)(jprob, ref[0], ref[1])
    assert path == jmg.shortest_path(jprob.edges, *ref_costs)
    assert path[0] == 0 and path[-1] == 1


def test_dijkstra_prefers_cheap_branch():
    # diamond: 0 -> {2 cheap, 3 expensive} -> 1
    edges = np.asarray([[0, 2], [0, 3], [2, 1], [3, 1]], np.int32)
    ec = torch.tensor([1.0, 1.0, 1.0, 1.0])
    nc = torch.tensor([0.0, 0.0, 0.1, 5.0])
    assert mg.shortest_path(edges, ec, nc) == [0, 2, 1]
    with pytest.raises(ValueError, match="no path"):
        mg.shortest_path(edges[:2], ec[:2], nc)


def test_large_graph_warns():
    """The dense-solve size guard warns past tens of nodes."""
    robot = make_robot_model(PointRobotFK(), [(0, 0.1, (0.0, 0.0, 0.0))], dtype=F64, device=CPU)
    xs = np.linspace(-2, 2, 21)
    X, Y = np.meshgrid(xs, xs)
    sdf = convert.planar_sdf_from_numpy([-2.0, -2.0], 0.2, np.sqrt(X**2 + Y**2) - 0.5,
                                        dtype=F64, device=CPU)
    M = 600  # 600 nodes x 4 vars = 2400 > 2048
    edges = np.stack([np.arange(M - 1), np.arange(1, M)], axis=1).astype(np.int32)
    z = torch.zeros(2, dtype=F64)
    prob = mg.make_multigraph_problem(robot, sdf, edges, z, z, z + 1, z, dt=0.1, Qc=np.eye(2),
                                      cost_sigma=0.1, epsilon=0.2, dtype=F64)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mg.optimize_multigraph(prob, torch.zeros((M, 2), dtype=F64),
                               torch.zeros((M, 2), dtype=F64), max_iter=1)
    assert any("dense normal equations" in str(x.message) for x in w)

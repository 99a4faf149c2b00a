"""The reference against the port on the CPU at small sizes, and the
configuration files against the port's presets: the occupancy grids,
the signed distance fields and their lookups, the sphere centres, and
the cost of a plan."""

import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import datasets, field, judge

CONFIG = {n: harness.load_json(os.path.join(harness.BENCH, "configs", n + ".json"))
          for n in ("wam7_desk", "mobile_se2")}
F64 = torch.float64


def test_occupancy_grids_equal_the_presets():
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, generate_3d_dataset

    assert np.array_equal(datasets.occupancy(CONFIG["wam7_desk"]["field"]),
                          generate_3d_dataset("WAMDeskDataset").map)
    # MobileMap1's boxes lie past the 500^2 grid that generate2Ddataset.m
    # declares; MATLAB's indexed assignment grows the map to cover them,
    # which the port's numpy preset does not: the grown map keeps the
    # preset's cells and adds the boxes beyond them
    mobile = CONFIG["mobile_se2"]["field"]
    grown = datasets.occupancy(mobile)
    preset = generate_2d_dataset("MobileMap1")
    assert grown.shape == tuple(mobile["shape"]) == (1499, 1499)
    assert np.array_equal(grown[:preset.rows, :preset.cols], preset.map)
    assert np.array_equal(datasets.occupancy(dict(mobile, shape=[preset.rows, preset.cols])),
                          grown)
    # the 1 x 5 m block at (0, 0) and the wall at y = 4.5 m, in cells of
    # (row = y, col = x) from the origin (-10, -10) at 0.01 m
    assert grown[750:1249, 950:1049].all() and not grown[749, 1000] and not grown[1249, 1000]
    assert grown[1400:1499, 500:1499].all() and grown.sum() == 405801


def test_robot_tables_equal_the_presets():
    from gpmp2_tpu_torch.robots import generate_arm, generate_mobile_base
    from benchmark.robots import dh_arm, se2_base

    for ours, theirs in ((dh_arm.build(CONFIG["wam7_desk"]["robot"], F64, "cpu"),
                          generate_arm("WAMArm", dtype=F64, device="cpu")),
                         (se2_base.build(CONFIG["mobile_se2"]["robot"], F64, "cpu"),
                          generate_mobile_base(dtype=F64, device="cpu"))):
        assert torch.equal(ours.sphere_link_ids, theirs.sphere_link_ids)
        assert torch.equal(ours.sphere_radii, theirs.sphere_radii)
        assert torch.equal(ours.sphere_centers, theirs.sphere_centers)
        assert type(ours.fk) is type(theirs.fk)
        for name in ("a", "alpha", "d", "theta_bias", "base_rot", "base_trans"):
            if hasattr(theirs.fk, name):
                assert torch.equal(getattr(ours.fk, name), getattr(theirs.fk, name)), name


def _small_occupancy(dim, rng):
    occ = np.zeros((24, 20, 16)[:dim])
    for _ in range(3):
        lo = [rng.integers(0, s - 4) for s in occ.shape]
        occ[tuple(slice(a, a + rng.integers(2, 5)) for a in lo)] = 1.0
    return occ


@pytest.mark.parametrize("dim", [2, 3])
def test_field_and_lookup_equal_the_port(dim):
    from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy, sdf_from_occupancy
    from gpmp2_tpu_torch.obstacle.sdf import sdf_lookup_points

    rng = np.random.default_rng(dim)
    occ = _small_occupancy(dim, rng)
    origin, cell = [-0.3, 0.2, -0.1][:dim], 0.05
    ours = field.Field(field.signed_distance(torch.as_tensor(occ > 0.5), cell), origin, cell)
    if dim == 3:
        port = sdf_from_occupancy(origin, cell, occ, dtype=F64, device="cpu")
        assert torch.allclose(ours.data, port.data.permute(2, 1, 0), atol=1e-12)
    else:
        port = planar_sdf_from_occupancy(origin, cell, occ, dtype=F64, device="cpu")
        assert torch.allclose(ours.data, port.data, atol=1e-12)
    sizes = torch.tensor(ours.sizes, dtype=F64) * cell
    pts = torch.as_tensor(origin, dtype=F64) + (torch.rand(500, dim, dtype=F64) * 1.2 - 0.1) * sizes
    pts3 = torch.cat([pts, torch.zeros(500, 3 - dim, dtype=F64)], -1)
    dist, ok = ours.lookup(pts3)
    pdist, *_, pok = sdf_lookup_points(port, pts3)
    assert torch.equal(ok, pok) and not ok.all() and ok.any()
    assert torch.allclose(dist, pdist, atol=1e-12)


def test_sphere_centres_equal_the_port():
    from gpmp2_tpu_torch.kinematics.robot import sphere_centers_world
    from benchmark.reference import dh_arm, se2_base
    from benchmark.robots import dh_arm as port_arm, se2_base as port_base

    q = torch.randn(5, 3, 7, dtype=F64)
    ours = dh_arm.Model(CONFIG["wam7_desk"]["robot"], "cpu").sphere_centers(q)
    port = sphere_centers_world(port_arm.build(CONFIG["wam7_desk"]["robot"], F64, "cpu"), q)
    assert torch.allclose(ours, port, atol=1e-12)
    p = torch.randn(5, 3, dtype=F64)
    ours = se2_base.Model(CONFIG["mobile_se2"]["robot"], "cpu").sphere_centers(p)
    port = sphere_centers_world(port_base.build(CONFIG["mobile_se2"]["robot"], F64, "cpu"), p)
    assert torch.allclose(ours, port, atol=1e-12)


@pytest.mark.parametrize("name", ["wam7_desk", "mobile_se2"])
def test_plan_cost_equals_the_ports_error(name):
    """On random trajectories (some spheres inside obstacles) the
    reference's cost and collision cost equal traj_error and
    collision_cost of the port in float64."""
    import importlib

    from gpmp2_tpu_torch import planner
    from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy, sdf_from_occupancy

    cfg = CONFIG[name]
    rng = np.random.default_rng(0)
    if name == "wam7_desk":
        occ = np.zeros((40, 40, 40))
        occ[22:30, 5:35, 5:35] = 1.0
        origin, cell = [-1.0, -1.0, -1.0], 0.05
        sdf = sdf_from_occupancy(origin, cell, occ, dtype=F64, device="cpu")
        ours = field.Field(field.signed_distance(torch.as_tensor(occ > 0.5), cell), origin, cell)
        s, g = rng.normal(size=(4, 7)), rng.normal(size=(4, 7))
    else:
        occ = np.zeros((60, 50))
        occ[20:30, 20:26] = 1.0
        origin, cell = [-3.0, -3.0], 0.1
        sdf = planar_sdf_from_occupancy(origin, cell, occ, dtype=F64, device="cpu")
        ours = field.Field(field.signed_distance(torch.as_tensor(occ > 0.5), cell), origin, cell)
        s = np.stack([rng.uniform(-2.5, -1.5, 4), rng.uniform(-2.5, -1.5, 4),
                      rng.uniform(-1, 1, 4)], -1)
        g = np.stack([rng.uniform(1, 2, 4), rng.uniform(1, 2, 4), rng.uniform(1, 3, 4)], -1)
    robot = importlib.import_module(f"benchmark.robots.{cfg['robot']['kind']}").build(
        cfg["robot"], F64, "cpu")
    st = dict(cfg["setting"], Qc=np.asarray(cfg["setting"]["Qc"]))
    setting = planner.TrajOptimizerSetting(**st)
    t = lambda x: torch.as_tensor(x, dtype=F64)  # noqa: E731
    z = torch.zeros(4, s.shape[1], dtype=F64)
    probs = planner.make_problem(robot, sdf, t(s), z, t(g), z, setting, sdf_pack=False,
                                 **cfg.get("problem", {}))
    init = planner.init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                           setting.total_step, setting.total_time)
    pose = init.pose + 0.2 * torch.randn_like(init.pose)
    vel = init.vel + 0.2 * torch.randn_like(init.vel)
    err = planner.traj_error(probs, planner.Trajectory(pose, vel))
    cc = planner.collision_cost(probs, pose)
    problem = judge.Problem(cfg, ours, "cpu")
    cost, rcc, progress = problem.judge(pose, vel, t(s), t(g))
    assert torch.allclose(cost, err, rtol=1e-10)
    assert torch.allclose(rcc, cc, atol=1e-12)
    assert torch.allclose(problem.cost(pose, vel, t(s), t(g)), cost, rtol=1e-12)
    assert torch.allclose(progress, problem.cost(init.pose, init.vel, t(s), t(g)) / cost,
                          rtol=1e-12)
    # the reference's straight line is the port's init, and makes no progress
    line = problem.straight_line(t(s), t(g))
    assert torch.allclose(line[0], init.pose, atol=1e-12)
    assert torch.allclose(line[1], init.vel, atol=1e-12)
    assert torch.equal(problem.judge(*line, t(s), t(g))[2], torch.ones(4, dtype=F64))
    if name == "wam7_desk":
        assert (cc > 0).any()

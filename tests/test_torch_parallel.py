"""The port's device mesh (parallel/mesh.py) and trajectory-sharded planner
on two gloo ranks, against one rank and the JAX package.

tests/test_sharding.py's point-robot setups: a module fixture starts this
file as a script twice (ranks 0 and 1 of a gloo group that meet on a
FileStore under a temporary directory), each rank runs every check below
and saves its results, and the tests compare them with the unsharded port
and with the JAX package's `plan_batch`. NCCL refuses two ranks on one
card, so more than one rank is tested on the CPU only. The script part
imports no JAX.

    python tests/test_torch_parallel.py RANK WORLD STORE OUT
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gpmp2_tpu_torch.kinematics.fk import PointRobotFK  # noqa: E402
from gpmp2_tpu_torch.kinematics.robot import make_robot_model  # noqa: E402
from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF  # noqa: E402
from gpmp2_tpu_torch.parallel import fleet_stats, make_mesh, shard_problems  # noqa: E402
from gpmp2_tpu_torch.planner import TrajOptimizerSetting, make_problem, plan_batch  # noqa: E402
from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting  # noqa: E402
from gpmp2_tpu_torch.planner.traj_utils import init_traj_straight_line  # noqa: E402

F64 = torch.float64
B_FLEET, B_LONG, LONG_STEPS, TS_PARTS = 16, 8, 256, 8
# the (dp, ts) meshes of the long-horizon planner
TS_SHAPES = [(1, 2), (2, 1)]


def _ball_field():
    """tests/test_sharding.py's 96^2 field: a disc of radius 0.3 at (0, 0.12)."""
    ys = -1.5 + 3.0 / 95 * np.arange(96)
    X, Y = np.meshgrid(ys, ys)
    return np.sqrt(X**2 + (Y - 0.12) ** 2) - 0.3


def _draws(B, seed):
    rng = np.random.default_rng(seed)
    starts = np.stack([np.full(B, -0.8), rng.uniform(-0.5, 0.5, B)], -1)
    goals = np.stack([np.full(B, 0.8), rng.uniform(-0.5, 0.5, B)], -1)
    return starts, goals


def _settings():
    """(fleet setting, long-horizon setting) of tests/test_sharding.py."""
    fleet = TrajOptimizerSetting(dof=2, total_step=8, total_time=5.0, obs_check_inter=2,
                                 opt_type="lm", max_iter=50, rel_thresh=1e-4, Qc=np.eye(2))
    long = TrajOptimizerSetting(dof=2, total_step=LONG_STEPS, total_time=5.0,
                                obs_check_inter=0, opt_type="lm", max_iter=30,
                                rel_thresh=1e-4, Qc=np.eye(2))
    return fleet, long


def port_setup(long):
    """The port's float64 problems, straight-line init and LM parameters on
    the CPU: the 16-problem fleet, or (long) the 8 problems of 257 states."""
    setting = _settings()[long]
    B, seed = (B_LONG, 3) if long else (B_FLEET, 0)
    s, g = (torch.as_tensor(x, dtype=F64) for x in _draws(B, seed))
    sdf = PlanarSDF(torch.tensor([-1.5, -1.5], dtype=F64), torch.tensor(3.0 / 95, dtype=F64),
                    torch.as_tensor(_ball_field(), dtype=F64))
    robot = make_robot_model(PointRobotFK(), [(0, 0.05, (0.0, 0.0, 0.0))], dtype=F64,
                             device="cpu")
    z = torch.zeros_like(s)
    probs = make_problem(robot, sdf, s, z, g, z, setting)
    init = init_traj_straight_line(probs.space, s, g, setting.total_step, setting.total_time)
    return probs, init, optimizer_params_from_setting(setting)


def _result(res):
    return {"error": res.error, "pose": res.traj.pose, "iterations": res.iterations,
            "converged": res.converged, "gave_up": res.gave_up}


def rank_main(rank, world, store, out):
    """One rank: every check of this file, its results saved to out/rank{rank}.pt."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    saved = {}
    dp = make_mesh(world, device="cpu")
    probs, init, params = port_setup(long=False)
    probs_s, init_s = shard_problems(dp, probs, init)
    res = plan_batch(probs_s, init_s, params)
    saved["fleet"] = _result(res)
    saved["stats"] = fleet_stats(dp, res)
    # an unpacked shared field shards as the packed one (the JAX package's
    # `packed=None` regression)
    probs_u = dataclasses.replace(probs, sdf=dataclasses.replace(probs.sdf, packed=None))
    saved["unpacked"] = _result(plan_batch(*shard_problems(dp, probs_u, init), params))
    probs, init, params = port_setup(long=True)
    meshes = {}
    for shape in TS_SHAPES:
        mesh = meshes[shape] = make_mesh(world, ("dp", "ts"), shape, device="cpu")
        saved[f"mesh{shape}"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names,
                                 mesh.get_local_rank("dp"), mesh.get_local_rank("ts"))
        params_ts = dataclasses.replace(params, ts_mesh=mesh, ts_parts=TS_PARTS)
        saved[f"ts{shape}"] = _result(plan_batch(*shard_problems(mesh, probs, init),
                                                 params_ts))
    errors = []
    try:  # 3 parts do not split over a ts dim of 2
        plan_batch(probs, init, dataclasses.replace(params, ts_mesh=meshes[(1, 2)],
                                                    ts_parts=3))
    except ValueError as e:
        errors.append(str(e))
    try:  # 3 lanes do not split over a dp dim of 2
        shard_problems(dp, probs.lanes(torch.arange(3)), init._replace(
            pose=init.pose[:3], vel=init.vel[:3]))
    except ValueError as e:
        errors.append(str(e))
    saved["errors"] = errors
    torch.save(saved, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' saved results, from two processes of this file."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(tmp / "store"), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def fleet_plain():
    probs, init, params = port_setup(long=False)
    return plan_batch(probs, init, params)


def _joined(ranks, key):
    return {k: torch.cat([r[key][k] for r in ranks]) for k in ranks[0][key]}


def test_dp_shards_equal_unsharded_and_jax(ranks, fleet_plain):
    """shard_problems + plan_batch on 2 ranks: the lanes in order equal the
    unsharded port's and the JAX package's plan_batch."""
    import jax
    import jax.numpy as jnp

    from gpmp2_tpu.kinematics.fk import PointRobotFK as JFK
    from gpmp2_tpu.kinematics.robot import make_robot_model as j_robot
    from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
    from gpmp2_tpu.planner import make_problem as j_make_problem
    from gpmp2_tpu.planner.batch import infer_batch_axes
    from gpmp2_tpu.planner.batch import plan_batch as j_plan_batch
    from gpmp2_tpu.planner.traj_utils import init_traj_straight_line as j_init

    got = _joined(ranks, "fleet")
    np.testing.assert_allclose(got["error"].numpy(), fleet_plain.error.numpy(), rtol=1e-8)
    np.testing.assert_allclose(got["pose"].numpy(), fleet_plain.traj.pose.numpy(), atol=1e-7)
    assert torch.equal(got["iterations"], fleet_plain.iterations)

    sdf = JPlanarSDF(origin=jnp.asarray([-1.5, -1.5]), cell_size=jnp.asarray(3.0 / 95),
                     data=jnp.asarray(_ball_field()))
    robot = j_robot(JFK(), [(0, 0.05, (0.0, 0.0, 0.0))], dtype=jnp.float64)
    setting = _settings()[0]
    s, g = (jnp.asarray(x) for x in _draws(B_FLEET, 0))
    z = jnp.zeros((B_FLEET, 2))
    probs = j_make_problem(robot, sdf, s, z, g, z, setting)
    axes = infer_batch_axes(probs, j_make_problem(robot, sdf, s[0], z[0], g[0], z[0], setting))
    init = jax.vmap(lambda a, c: j_init(robot.space, a, c, 8, 5.0))(s, g)
    from gpmp2_tpu.planner.batch import optimizer_params_from_setting as j_params

    ref = jax.jit(lambda p, t: j_plan_batch(p, t, j_params(setting), axes))(probs, init)
    np.testing.assert_allclose(got["error"].numpy(), np.asarray(ref.error), rtol=1e-8)
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(ref.traj.pose), atol=1e-7)


def test_fleet_stats_equal_host_sums(ranks):
    got = _joined(ranks, "fleet")
    for r in ranks:
        stats = r["stats"]
        assert float(stats["n"]) == B_FLEET
        assert float(stats["converged"]) == float(got["converged"].sum())
        assert float(stats["gave_up"]) == float(got["gave_up"].sum())
        np.testing.assert_allclose(float(stats["mean_error"]), float(got["error"].mean()),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(stats["mean_iters"]),
                                   float(got["iterations"].double().mean()), rtol=1e-12)


def test_unpacked_sdf_shards(ranks):
    got, packed = _joined(ranks, "unpacked"), _joined(ranks, "fleet")
    assert bool(torch.isfinite(got["error"]).all())
    np.testing.assert_allclose(got["error"].numpy(), packed["error"].numpy(), rtol=1e-8)


@pytest.fixture(scope="module")
def long_plain():
    probs, init, params = port_setup(long=True)
    return plan_batch(probs, init, params)


@pytest.mark.parametrize("shape", TS_SHAPES)
def test_ts_planner_equals_single_rank(ranks, long_plain, shape):
    """The 257-state planner through the ts-sharded solve (8 parts) on a
    (dp, ts) mesh equals the single-rank solve (K1's plain sweep)."""
    key = f"ts{shape}"
    if shape[0] == 1:  # both ranks hold every lane, and the same values
        for k in ranks[0][key]:
            assert torch.equal(ranks[0][key][k], ranks[1][key][k]), k
        got = ranks[0][key]
    else:
        got = _joined(ranks, key)
    assert bool(got["converged"].all())
    np.testing.assert_allclose(got["error"].numpy(), long_plain.error.numpy(), rtol=1e-8)
    np.testing.assert_allclose(got["pose"].numpy(), long_plain.traj.pose.numpy(), atol=1e-6)
    assert torch.equal(got["iterations"], long_plain.iterations)


def test_opt_in_partitioned_planner(long_plain, monkeypatch):
    """GPMP2_TPU_PARTITIONED=1 turns the 257-state planner's damped solve
    into the one-process Schur solve with max(2, min(64, 257 // 64)) = 4
    parts; the result equals the sequential sweep's."""
    from gpmp2_tpu_torch.solver import partitioned

    calls = []
    real = partitioned.block_tridiag_solve_partitioned

    def spy(D, U, b, n_parts, jacobi_scaling=True):
        calls.append(n_parts)
        return real(D, U, b, n_parts, jacobi_scaling)

    monkeypatch.setattr(partitioned, "block_tridiag_solve_partitioned", spy)
    monkeypatch.setenv("GPMP2_TPU_PARTITIONED", "1")
    got = plan_batch(*port_setup(long=True))
    assert calls and set(calls) == {4}
    np.testing.assert_allclose(got.error.numpy(), long_plain.error.numpy(), rtol=1e-8)
    np.testing.assert_allclose(got.traj.pose.numpy(), long_plain.traj.pose.numpy(), atol=1e-6)
    assert torch.equal(got.iterations, long_plain.iterations)


def test_make_mesh_shapes(ranks):
    for r, saved in enumerate(ranks):
        assert saved["mesh(2, 1)"] == ((2, 1), ("dp", "ts"), r, 0)
        assert saved["mesh(1, 2)"] == ((1, 2), ("dp", "ts"), 0, r)


def test_indivisible_splits_raise(ranks):
    for saved in ranks:
        parts, lanes = saved["errors"]
        assert "n_parts=3" in parts and "'ts' (size 2)" in parts
        assert "batch of 3" in lanes


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

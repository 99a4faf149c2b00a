"""The port's trajectory densification, dynamics exports, verbosity trace
and utilities against the JAX package, float64 on the CPU.

- `interpolate_traj` on a vector, an SE(2) and an SE(2) x R^2 trajectory
  (and a batch of vector ones) at rtol 1e-12;
- `simple_2d_vehicle_dynamics_pose2` / `_vector3` at rtol 1e-12, and
  traj_linearize's vehicle-dynamics residual computed through them;
- the verbosity trace of one LM solve: the port's printed lines against
  the JAX package's jax.debug.print lines (loop='dynamic', which stops
  when the port's loop stops), field by field; nothing printed when it is
  off; the setting's setters and `optimizer_params_from_setting`;
- `.npz` SDFs (planar and 3D) and trajectories written by one package and
  read by the other, bit-equal both ways; a small `.vol` pair read by
  both; the flat-buffer interop round trip and its errors; `Timer`;
  `collision_cost_batch`.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.dynamics import simple_2d_vehicle_dynamics_pose2 as j_dyn_pose2
from gpmp2_tpu.dynamics import simple_2d_vehicle_dynamics_vector3 as j_dyn_vector3
from gpmp2_tpu.geometry.statespace import SE2Space as JSE2Space
from gpmp2_tpu.geometry.statespace import SE2VectorSpace as JSE2VectorSpace
from gpmp2_tpu.geometry.statespace import VectorSpace as JVectorSpace
from gpmp2_tpu.obstacle.sdf import PlanarSDF as JPlanarSDF
from gpmp2_tpu.obstacle.sdf import SignedDistanceField as JSDF
from gpmp2_tpu.planner.factor_graph import FactorGraph as JFactorGraph
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.planner.traj_utils import interpolate_traj as j_interpolate_traj
from gpmp2_tpu.solver.optimize import OptimizerParams as JOptimizerParams
from gpmp2_tpu.utils import fileio as jfileio
from gpmp2_tpu.utils import interop as jinterop
from gpmp2_tpu_torch.dynamics import (simple_2d_vehicle_dynamics_pose2,
                                      simple_2d_vehicle_dynamics_vector3)
from gpmp2_tpu_torch.geometry.statespace import SE2Space, SE2VectorSpace, VectorSpace
from gpmp2_tpu_torch.obstacle.sdf import PlanarSDF, SignedDistanceField
from gpmp2_tpu_torch.planner import (FactorGraph, Trajectory, TrajOptimizerSetting,
                                     collision_cost, collision_cost_batch,
                                     init_traj_straight_line, interpolate_traj,
                                     optimizer_params_from_setting)
from gpmp2_tpu_torch.planner.problem import _dyn_residual
from gpmp2_tpu_torch.solver.optimize import OptimizerParams
from gpmp2_tpu_torch.utils import (Timer, buffer_to_trajectory, load_sdf, load_trajectory,
                                   read_sdf_vol_file, save_sdf, save_trajectory,
                                   trajectory_to_buffer)
from test_torch_factor_graph import (ROBOT, SDF, _planner_recipe, build, circle_fields,
                                     point_robot, recipe)

F64 = torch.float64
CPU = "cpu"

SPACES = {"vector": (VectorSpace(3), JVectorSpace(3)), "se2": (SE2Space(), JSE2Space()),
          "se2_vector": (SE2VectorSpace(2), JSE2VectorSpace(2))}


@pytest.mark.parametrize("kind", list(SPACES))
def test_interpolate_traj_matches_jax(kind):
    space, jspace = SPACES[kind]
    d = space.dim
    rng = np.random.default_rng(len(kind))
    pose = np.cumsum(0.3 * rng.normal(size=(5, d)), axis=0)
    vel = rng.normal(size=(5, d))
    Qc = 0.7 * np.eye(d) + 0.1 * (np.ones((d, d)) - np.eye(d))
    for inter in (0, 3):
        got = interpolate_traj(space, Trajectory(torch.from_numpy(pose), torch.from_numpy(vel)),
                               Qc, 0.4, inter)
        ref = jax.jit(j_interpolate_traj, static_argnums=(0, 4))(
            jspace, JTrajectory(jnp.asarray(pose), jnp.asarray(vel)), jnp.asarray(Qc), 0.4, inter)
        assert got.pose.shape == (4 * (inter + 1) + 1, d)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)
        # the support states are kept at every (inter + 1)-th row
        np.testing.assert_array_equal(got.pose[::inter + 1].numpy(), pose)


def test_interpolate_traj_batched():
    space = VectorSpace(2)
    rng = np.random.default_rng(1)
    pose, vel = (torch.from_numpy(rng.normal(size=(3, 4, 2))) for _ in range(2))
    got = interpolate_traj(space, Trajectory(pose, vel), np.eye(2), 0.5, 2)
    for b in range(3):
        one = interpolate_traj(space, Trajectory(pose[b], vel[b]), np.eye(2), 0.5, 2)
        torch.testing.assert_close(got.pose[b], one.pose, rtol=1e-14, atol=1e-15)
        torch.testing.assert_close(got.vel[b], one.vel, rtol=1e-14, atol=1e-15)


def test_dynamics_exports_match_jax():
    rng = np.random.default_rng(2)
    conf, vel = rng.normal(size=(6, 5)), rng.normal(size=(6, 5))
    np.testing.assert_allclose(simple_2d_vehicle_dynamics_pose2(torch.from_numpy(vel)).numpy(),
                               np.asarray(j_dyn_pose2(jnp.asarray(vel))), rtol=1e-12)
    got = simple_2d_vehicle_dynamics_vector3(torch.from_numpy(conf), torch.from_numpy(vel))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_dyn_vector3(jnp.asarray(conf),
                                                                     jnp.asarray(vel))),
                               rtol=1e-12)

    class Stub:  # the two fields _dyn_residual reads
        space = VectorSpace(5)

    r, _ = _dyn_residual(Stub(), torch.from_numpy(conf), torch.from_numpy(vel))
    assert torch.equal(r[..., 0], got)


# ---- the verbosity trace -------------------------------------------------------

TRACE = re.compile(r"\[optimize\] accepted (\d+)/(\d+) err\(mean\) (\S+) tr\(mean\) (\S+) "
                   r"active (\d+) converged (\d+) gave_up (\d+)")


def _trace(text):
    return [m.groups() for m in TRACE.finditer(text)]


def _trace_graphs():
    """A small point-robot graph beside the circle: 4 states, one
    interpolated factor per interval."""
    jr, r = point_robot()
    jsdf, sdf = circle_fields()
    start, goal = np.array([-1.5, -1.2]), np.array([1.5, 1.3])
    fs = recipe(3, 3.0, 1, start, goal)
    line = init_traj_straight_line(r.space, torch.tensor(start), torch.tensor(goal), 3, 3.0)
    return (build(JFactorGraph, jr.space, 4, fs, {ROBOT: jr, SDF: jsdf}),
            build(FactorGraph, r.space, 4, fs, {ROBOT: r, SDF: sdf}), line)


def test_verbosity_trace_matches_jax(capfd):
    jg, g, line = _trace_graphs()
    capfd.readouterr()
    g.optimize(line, OptimizerParams(method="lm", max_iter=60, rel_thresh=1e-5,
                                     verbosity="error"))
    got = _trace(capfd.readouterr().out)
    jparams = JOptimizerParams(method="lm", max_iter=60, rel_thresh=1e-5, verbosity="error",
                               loop="dynamic")
    jax.block_until_ready(jax.jit(lambda t: jg.optimize(t, jparams))(
        JTrajectory(jnp.asarray(line.pose.numpy()), jnp.asarray(line.vel.numpy()))))
    jax.effects_barrier()
    ref = _trace(capfd.readouterr().out)
    assert len(got) == len(ref) > 3
    for a, b in zip(got, ref):
        for k in (0, 1, 4, 5, 6):  # accepted, batch, active, converged, gave_up
            assert a[k] == b[k], (a, b)
        for k in (2, 3):  # err(mean) to 6 digits, tr(mean) to 4
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-5), (a, b)
    g.optimize(line, OptimizerParams(method="lm", max_iter=60, rel_thresh=1e-5))
    assert "[optimize]" not in capfd.readouterr().out


def test_verbosity_setting():
    s = TrajOptimizerSetting(dof=2)
    assert s.verbosity == "none"
    assert optimizer_params_from_setting(s).verbosity == "none"
    s.set_verbosity_error()
    assert optimizer_params_from_setting(s).verbosity == "error"
    s.set_verbosity_none()
    assert s.verbosity == "none"
    with pytest.raises(AssertionError):
        TrajOptimizerSetting(dof=2, verbosity="loud")


# ---- file IO ------------------------------------------------------------------------

def _fields(dim):
    rng = np.random.default_rng(dim)
    data = rng.normal(size=(5, 6) if dim == 2 else (4, 5, 6)).astype(np.float32)
    origin = rng.normal(size=dim).astype(np.float32)
    cell = np.float32(0.05)
    J = (JPlanarSDF if dim == 2 else JSDF)(jnp.asarray(origin), jnp.asarray(cell),
                                          jnp.asarray(data))
    P = (PlanarSDF if dim == 2 else SignedDistanceField)(
        torch.from_numpy(origin), torch.tensor(cell), torch.from_numpy(data))
    return J, P


@pytest.mark.parametrize("dim", [2, 3])
def test_sdf_npz_crossloads(tmp_path, dim):
    jsdf, sdf = _fields(dim)
    save_sdf(str(tmp_path / "port.npz"), sdf)
    jfileio.save_sdf(str(tmp_path / "jax.npz"), jsdf)
    from_port = jfileio.load_sdf(str(tmp_path / "port.npz"))
    from_jax = load_sdf(str(tmp_path / "jax.npz"), device=CPU)
    assert type(from_port) is type(jsdf) and type(from_jax) is type(sdf)
    for name in ("origin", "cell_size", "data"):
        want = getattr(sdf, name).numpy()
        assert np.asarray(getattr(from_port, name)).tobytes() == want.tobytes()
        assert getattr(from_jax, name).numpy().tobytes() == want.tobytes()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_trajectory_npz_crossloads(tmp_path):
    rng = np.random.default_rng(4)
    pose, vel = rng.normal(size=(2, 6, 3)), rng.normal(size=(2, 6, 3))
    save_trajectory(str(tmp_path / "port.npz"), Trajectory(torch.from_numpy(pose),
                                                           torch.from_numpy(vel)))
    jfileio.save_trajectory(str(tmp_path / "jax.npz"), JTrajectory(jnp.asarray(pose),
                                                                   jnp.asarray(vel)))
    a = jfileio.load_trajectory(str(tmp_path / "port.npz"), dtype=jnp.float64)
    b = load_trajectory(str(tmp_path / "jax.npz"), dtype=F64, device=CPU)
    for x, y, want in ((a.pose, b.pose, pose), (a.vel, b.vel, vel)):
        assert np.asarray(x).tobytes() == want.tobytes() == y.numpy().tobytes()


def test_read_sdf_vol_file(tmp_path):
    cols, rows, nz = 4, 3, 2
    vals = np.arange(cols * rows * nz, dtype=np.float64) * 0.25 - 1.0
    pre = str(tmp_path / "field")
    with open(pre + ".vol.head", "w") as f:
        f.write(f"{cols} {rows} {nz}\n0.5 -1.0 0.25\n0.1\n")
    np.savetxt(pre + ".vol.data", vals)
    got = read_sdf_vol_file(pre, dtype=F64, device=CPU)
    ref = jfileio.read_sdf_vol_file(pre, dtype=jnp.float64)
    assert got.data.shape == (nz, rows, cols)
    for name in ("origin", "cell_size", "data"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    # file order x, then y, then z innermost last: value of (x, y, z)
    assert float(got.data[1, 2, 3]) == vals[(3 * rows + 2) * nz + 1]
    with open(pre + ".vol.head", "w") as f:
        f.write(f"{cols} {rows} 3\n0.5 -1.0 0.25\n0.1\n")
    with pytest.raises(ValueError, match="size mismatch"):
        read_sdf_vol_file(pre, device=CPU)


def test_interop_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    pose, vel = rng.normal(size=(6, 4)), rng.normal(size=(6, 4))
    lo, hi = -0.5 * np.ones(4), 0.5 * np.ones(4)
    buf = trajectory_to_buffer(Trajectory(torch.from_numpy(pose), torch.from_numpy(vel)),
                               torch.from_numpy(lo), hi)
    np.testing.assert_array_equal(buf, jinterop.trajectory_to_buffer(
        JTrajectory(pose, vel), lo, hi))
    conf, v = buffer_to_trajectory(buf.ravel(), 4)
    np.testing.assert_array_equal(conf, np.clip(pose, lo, hi))
    np.testing.assert_array_equal(v, vel)
    with pytest.raises(ValueError, match="differs from dof"):
        trajectory_to_buffer(Trajectory(torch.zeros(3, 4), torch.zeros(3, 4)), np.zeros(3),
                             np.zeros(4))
    with pytest.raises(ValueError, match="not an even"):
        buffer_to_trajectory(np.zeros((5, 4)), 4)


def test_timer(capsys):
    t = Timer("plan")
    t.tic()
    x = torch.ones(100).sum()
    first = t.toc(x, (x, [x]))
    assert isinstance(first, int) and first >= 0 and t.acc_us() == first
    t.tic()
    t.toc()
    assert t.acc_us() >= first
    t.print()
    assert capsys.readouterr().out.startswith("plan: ")
    t.reset()
    assert t.acc_us() == 0


def test_collision_cost_batch():
    _, probs, traj = _planner_recipe("point_robot")
    batched = Trajectory(traj.pose[None], traj.vel[None])
    assert torch.equal(collision_cost_batch(probs, batched), collision_cost(probs, batched.pose))

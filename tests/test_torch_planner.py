"""Port's plan_batch end to end vs the JAX package's, float64 on the CPU.

Same problems (the synthetic world of test_torch_linearize.py, built from
the JAX objects' leaves), same initial trajectories. On the CPU the JAX
planner solves with its scan solver (the Pallas gate declines off-TPU),
the port with its plain solve. Iteration counts are compared only on lanes
whose last relative decrease is not within 1e-3 of rel_thresh: there a
last-digit difference may flip GTSAM's stopping test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.planner.batch import optimizer_params_from_setting as j_params_from
from gpmp2_tpu.planner.batch import plan_batch as j_plan_batch
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.robots import generate_arm as j_generate_arm
from gpmp2_tpu_torch.planner.batch import (batch_traj_optimize,
                                           optimizer_params_from_setting,
                                           plan_batch)
from gpmp2_tpu_torch.planner.problem import Trajectory
from gpmp2_tpu_torch.planner.traj_utils import init_traj_straight_line
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.utils.convert import sdf_from_numpy
from test_torch_linearize import (CELL, ORIGIN, jax_problem, port_problem,
                                  wam_endpoints, wam_setting, world_field)

F64 = jnp.float64


@pytest.mark.parametrize("opt_type", ["lm", "gaussnewton"])
def test_plan_batch_matches_jax(opt_type):
    B = 4
    setting = wam_setting(total_step=5, inter=3, opt_type=opt_type)
    starts, goals = wam_endpoints(B, seed=3)
    jprob, axes = jax_problem(j_generate_arm("WAMArm", dtype=F64), world_field(),
                              starts, goals, setting)
    tprob = port_problem(jprob)
    init = init_traj_straight_line(tprob.space, tprob.start_pose, tprob.end_pose,
                                   setting.total_step, setting.total_time)

    # the static loop compiles fastest; every loop gives the same per-lane
    # results (tests/test_solver.py)
    ref = j_plan_batch(jprob, JTrajectory(jnp.asarray(init.pose.numpy()),
                                          jnp.asarray(init.vel.numpy())),
                       dataclasses.replace(j_params_from(setting), loop="static"), axes)
    params = optimizer_params_from_setting(setting)
    got = plan_batch(tprob, init, params)

    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.gave_up.numpy(), np.asarray(ref.gave_up))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(ref.error), rtol=1e-6)
    np.testing.assert_allclose(got.traj.pose.numpy(), np.asarray(ref.traj.pose), atol=1e-6)
    np.testing.assert_allclose(got.traj.vel.numpy(), np.asarray(ref.traj.vel), atol=1e-6)
    assert bool(got.converged.any())

    # the error one accepted step before the end: rerun with max_iter cut
    iters = got.iterations.numpy()
    comparable = []
    for lane in range(B):
        k = int(iters[lane])
        if k == 0:
            continue
        prev = plan_batch(tprob, init, dataclasses.replace(params, max_iter=k - 1)).error[lane]
        rel = float((prev - got.error[lane]) / prev)
        if abs(rel - params.rel_thresh) > 1e-3:
            comparable.append(lane)
    assert comparable
    np.testing.assert_array_equal(iters[comparable],
                                  np.asarray(ref.iterations)[comparable])


def test_batch_traj_optimize_single_problem():
    """The unbatched entry point plans one problem and drops the batch axis."""
    setting = wam_setting()
    starts, goals = wam_endpoints(2, seed=3)
    sdf = sdf_from_numpy(ORIGIN, CELL, world_field(), dtype=torch.float64, device="cpu")
    robot = generate_arm("WAMArm", dtype=torch.float64, device="cpu")
    one = batch_traj_optimize(robot, sdf, torch.from_numpy(starts[0]),
                              torch.zeros(7, dtype=torch.float64),
                              torch.from_numpy(goals[0]),
                              torch.zeros(7, dtype=torch.float64), setting)
    both = batch_traj_optimize(robot, sdf, torch.from_numpy(starts),
                               torch.zeros(2, 7, dtype=torch.float64),
                               torch.from_numpy(goals),
                               torch.zeros(2, 7, dtype=torch.float64), setting)
    assert one.traj.pose.shape == (6, 7) and one.error.shape == ()
    np.testing.assert_allclose(one.traj.pose.numpy(), both.traj.pose[0].numpy(),
                               atol=1e-9)
    assert isinstance(both.traj, Trajectory)

"""The port's Dogleg optimizer, float64 on the CPU.

- against the JAX package's optimize_batch(method="dogleg") on identical
  small vector problems (built from the JAX objects' leaves): final error
  at rel 1e-6, the same converged and gave-up lanes, and equal iteration
  counts except on lanes whose last relative decrease lies within 1e-3
  of rel_thresh (there a last-digit difference may flip GTSAM's stopping
  test);
- the Dogleg rows of the point-robot, Arm3 and WAM oracle fixtures
  (tests/test_parity_oracle.py): within 1% of the oracle's Dogleg cost,
  converged, not given up;
- a lane whose error no step can decrease: its radius collapses below
  delta_min and it gives up, while the other lane converges
  (tests/test_solver.py::test_gave_up_dogleg_radius_collapse);
- a `TrajOptimizerSetting` left at its default optimizer (Dogleg, the
  reference's default) plans through `batch_traj_optimize`.
"""

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.planner.batch import plan_batch as j_plan_batch
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.solver.optimize import OptimizerParams as JOptimizerParams
from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, batch_traj_optimize,
                                     init_traj_straight_line, optimizer_params_from_setting,
                                     plan_batch)
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.solver.optimize import OptimizerParams, optimize_batch
from test_torch_suite import _arm3_limits, _point_worlds, arm3_case, box_sdf, pointrobot_case

F64 = torch.float64


@pytest.mark.parametrize("case", [_point_worlds, _arm3_limits],
                         ids=["point_worlds", "arm3_limits"])
def test_dogleg_matches_jax(case):
    jprob, axes, tprob = case()
    init = init_traj_straight_line(tprob.space, tprob.start_pose, tprob.end_pose, jprob.N,
                                   float(jprob.dt) * jprob.N)
    # the static loop compiles fastest; every loop gives the same per-lane
    # results (tests/test_solver.py)
    jparams = JOptimizerParams(method="dogleg", loop="static")
    params = OptimizerParams(method="dogleg")
    for f in ("max_iter", "rel_thresh", "abs_thresh", "delta_init", "delta_min",
              "reject_budget"):
        assert getattr(params, f) == getattr(jparams, f), f
    ref = j_plan_batch(jprob, JTrajectory(jnp.asarray(init.pose.numpy()),
                                          jnp.asarray(init.vel.numpy())), jparams, axes)
    got = plan_batch(tprob, init, params)

    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_array_equal(got.gave_up.numpy(), np.asarray(ref.gave_up))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(ref.error), rtol=1e-6)
    assert bool(got.converged.all())

    iters = got.iterations.numpy()
    # the error one accepted step before the end, one solve per distinct count
    before = {k: plan_batch(tprob, init, dataclasses.replace(params, max_iter=int(k) - 1)).error
              for k in set(iters.tolist()) - {0}}
    comparable = []
    for lane, k in enumerate(iters):
        if k == 0:
            continue
        prev = before[int(k)]
        rel = float((prev[lane] - got.error[lane]) / prev[lane])
        if abs(rel - params.rel_thresh) > 1e-3:
            comparable.append(lane)
    assert comparable
    np.testing.assert_array_equal(iters[comparable], np.asarray(ref.iterations)[comparable])


def _oracle_dogleg(fx, robot, sdf, setting, **problem_kwargs):
    """Dogleg from the oracle's endpoints at the fixture's rel_tol."""
    setting = dataclasses.replace(setting, opt_type="dogleg", max_iter=200,
                                  rel_thresh=float(fx["trust_rel_tol"]))
    d = robot.dof
    zeros = torch.zeros(d, dtype=F64)
    res = batch_traj_optimize(robot, sdf, torch.as_tensor(fx["meta_start"], dtype=F64), zeros,
                              torch.as_tensor(fx["meta_end"], dtype=F64), zeros, setting,
                              **problem_kwargs)
    assert bool(res.converged) and not bool(res.gave_up)
    assert float(res.error) <= float(fx["dogleg_final_error"]) * 1.01 + 1e-9


@pytest.mark.parametrize("case", [pointrobot_case, arm3_case], ids=["pointrobot2d", "arm3"])
def test_oracle_dogleg(case):
    fx, robot, setting = case()
    _oracle_dogleg(fx, robot, box_sdf(fx), setting)


def test_oracle_dogleg_wam():
    from test_torch_oracle_wam import FIXTURE

    fx = np.load(FIXTURE, allow_pickle=True)
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=F64, device="cpu")
    setting = TrajOptimizerSetting(
        dof=7, total_step=int(fx["meta_n_steps"]), total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]), cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]))
    _oracle_dogleg(fx, generate_arm("WAMArm", dtype=F64, device="cpu"), sdf, setting,
                   sdf_pack=False)


def test_dogleg_radius_collapse_gives_up():
    """Lane 0: a quadratic. Lane 1: a constant error with a bogus gradient,
    so no step decreases it and its radius halves until it gives up."""
    n, m = 2, 1
    target = torch.ones((n, m), dtype=F64)

    class State(NamedTuple):
        x: torch.Tensor  # (2, n, m)

    def linearize(state):
        x = state.x
        err = torch.stack([0.5 * ((x[0] - target) ** 2).sum(), torch.ones((), dtype=F64)])
        H = torch.eye(m, dtype=F64).expand(2, n, m, m).contiguous()
        b = torch.stack([target - x[0], torch.ones((n, m), dtype=F64)])
        return H, torch.zeros((2, n - 1, m, m), dtype=F64), b, err

    res = optimize_batch(linearize, lambda s, d: State(s.x + d),
                         State(torch.zeros((2, n, m), dtype=F64)),
                         OptimizerParams(method="dogleg", max_iter=60, reject_budget=30))
    assert bool(res.gave_up[1]) and not bool(res.converged[1])
    assert bool(res.converged[0]) and not bool(res.gave_up[0])
    assert float(res.error[1]) == 1.0


def test_default_setting_plans_with_dogleg():
    """A setting that leaves opt_type at its default runs Dogleg."""
    fx, robot, _ = pointrobot_case()
    setting = TrajOptimizerSetting(
        dof=2, total_step=int(fx["meta_n_steps"]), total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]), cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]))
    assert setting.opt_type == "dogleg"
    assert optimizer_params_from_setting(setting).method == "dogleg"
    zeros = torch.zeros(2, dtype=F64)
    res = batch_traj_optimize(robot, box_sdf(fx), torch.as_tensor(fx["meta_start"]), zeros,
                              torch.as_tensor(fx["meta_end"]), zeros, setting)
    assert bool(res.converged) and not bool(res.gave_up)
    assert bool(torch.isfinite(res.traj.pose).all())
    # default rel_thresh 1e-2 stops short of the fixture's 1e-4 optimum
    assert float(res.error) <= float(fx["dogleg_final_error"]) * 1.5

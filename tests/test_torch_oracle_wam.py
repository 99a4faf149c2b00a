"""The port against the GTSAM-semantics oracle on the canonical WAM problem.

Mirrors tests/test_parity_oracle.py::TestWAM7 with the port alone: the
full 300^3 WAMDeskDataset SDF built in float64 on the CPU with the port's
own EDT, held against tests/fixtures/oracle_wam7_3d.npz, which shares no
code with either package.
"""

import os

import numpy as np
import pytest
import torch

from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_from_occupancy
from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting,
                                     batch_traj_optimize, init_traj_straight_line,
                                     make_problem, traj_error)
from gpmp2_tpu_torch.robots import generate_arm

F64 = torch.float64
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "oracle_wam7_3d.npz")


def test_wam7_oracle_parity():
    fx = np.load(FIXTURE, allow_pickle=True)
    ds = generate_3d_dataset("WAMDeskDataset")
    sdf = sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=F64, device="cpu")
    robot = generate_arm("WAMArm", dtype=F64, device="cpu")
    setting = TrajOptimizerSetting(
        dof=7, total_step=int(fx["meta_n_steps"]),
        total_time=float(fx["meta_total_time"]),
        obs_check_inter=int(fx["meta_inter"]),
        cost_sigma=float(fx["meta_cost_sigma"]),
        epsilon=float(fx["meta_eps"]),
        opt_type="lm", max_iter=100,
    )
    start = torch.as_tensor(fx["meta_start"], dtype=F64)
    end = torch.as_tensor(fx["meta_end"], dtype=F64)
    zeros = torch.zeros(7, dtype=F64)
    # sdf_pack=False: the 300^3 float64 field would pack into a 1.7 GB table
    prob = make_problem(robot, sdf, start[None], zeros[None], end[None],
                        zeros[None], setting, sdf_pack=False)

    # every factor at the oracle's initial and optimized trajectories
    def err(pose_key, vel_key):
        traj = Trajectory(torch.as_tensor(fx[pose_key])[None],
                          torch.as_tensor(fx[vel_key])[None])
        return float(traj_error(prob, traj)[0])

    assert err("init_pose", "init_vel") == pytest.approx(float(fx["init_error"]), rel=1e-8)
    assert err("opt_pose", "opt_vel") == pytest.approx(float(fx["final_error"]), rel=1e-6)

    # the straight-line initialization
    mine = init_traj_straight_line(robot.space, start, end,
                                   int(fx["meta_n_steps"]),
                                   float(fx["meta_total_time"]))
    np.testing.assert_allclose(mine.pose.numpy(), fx["init_pose"], atol=1e-12)
    np.testing.assert_allclose(mine.vel.numpy(), fx["init_vel"], atol=1e-12)

    # LM within 1% of the oracle's final cost, converged, not given up
    res = batch_traj_optimize(robot, sdf, start, zeros, end, zeros, setting,
                              sdf_pack=False)
    assert bool(res.converged) and not bool(res.gave_up)
    assert float(res.error) <= float(fx["final_error"]) * 1.01 + 1e-9

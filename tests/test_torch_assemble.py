"""The vector-space linearize's assembly (gpmp2_tpu_torch/ops/assemble.py)
on the CPU: the route's truth table, and the plain version of the assembly
kernel on the operands `traj_linearize` hands the kernel, held to the
linearize's own torch code, float64. The kernel against both on the card:
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
from gpmp2_tpu_torch.kinematics import PointRobotFK, make_robot_model
from gpmp2_tpu_torch.ops import assemble
from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting,
                                     init_traj_straight_line, make_problem, traj_linearize)
from gpmp2_tpu_torch.planner.problem import _assembly_operands, _collision_confs, _spheres_and_jac
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.utils import convert

F32, F64 = torch.float32, torch.float64
CPU = torch.device("cpu")


@pytest.mark.parametrize("vector,cuda,dtype,d,S,T,taken", [
    (True, True, F32, 7, 16, 9, True),      # the WAM main path
    (True, True, F64, 7, 16, 9, True),      # its float64 rescue
    (True, True, F32, 2, 1, 3, True),       # the point robot
    (True, True, F32, 3, 16, 0, True),      # no interpolated states
    (True, True, F32, 8, 64, 16, True),     # the edge of the built range
    (False, True, F32, 3, 1, 3, False),     # SE(2): a Lie space never takes it
    (False, True, F64, 18, 65, 1, False),   # SE(2) x R^15 (PR2)
    (True, False, F64, 7, 16, 9, False),    # CPU tensors
    (True, True, torch.float16, 7, 16, 9, False),
    (True, True, F32, 9, 16, 9, False),     # past the built range
    (True, True, F32, 7, 65, 9, False),
    (True, True, F32, 7, 16, 17, False),
])
def test_route_truth_table(vector, cuda, dtype, d, S, T, taken):
    assert assemble.route(vector, cuda, dtype, d, S, T) is taken


def _wam(inter):
    n, cell, origin = 40, 0.1, np.array([-2.013, -2.021, -1.007])
    Z, Y, X = np.meshgrid(*(origin[k] + cell * np.arange(n) for k in (2, 1, 0)),
                          indexing="ij")
    data = np.sqrt((X - 0.3) ** 2 + (Y + 0.2) ** 2 + (Z - 0.4) ** 2) - 0.3
    sdf = convert.sdf_from_numpy(origin, cell, data, dtype=F64, device=CPU)
    start = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    goal = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    return generate_arm("WAMArm", dtype=F64, device=CPU), sdf, start, goal, inter


def _planar_arm(inter):
    occ = np.zeros((60, 60))
    occ[20:30, 35:45] = 1.0
    sdf = planar_sdf_from_occupancy(np.array([-3.0, -3.0]), 0.1, occ, dtype=F64, device=CPU)
    return (generate_arm("SimpleThreeLinksArm", dtype=F64, device=CPU), sdf,
            np.array([-0.5, 0.3, 0.4]), np.array([1.2, -0.4, 0.2]), inter)


def _point(inter):
    occ = np.zeros((80, 80))
    occ[35:55, 30:50] = 1.0
    sdf = planar_sdf_from_occupancy(np.array([-2.0, -2.0]), 0.05, occ, dtype=F64, device=CPU)
    robot = make_robot_model(PointRobotFK(), [(0, 0.1, (0.0, 0.0, 0.0))], dtype=F64,
                             device=CPU)
    return robot, sdf, np.array([-1.5, -1.2]), np.array([1.5, 1.4]), inter


@pytest.mark.parametrize("case", [
    lambda: _wam(9), lambda: _wam(0), lambda: _planar_arm(3), lambda: _point(5),
], ids=["wam", "wam_no_inter", "planar_arm", "point_robot"])
def test_plain_assembly_matches_the_torch_path(case):
    """The plain assembly of `_assembly_operands` equals the linearize's
    torch code (no optional factor present), each output within 1e-12 of
    its scale, on perturbed straight lines of 4 problems."""
    robot, sdf, start, goal, inter = case()
    B, d = 4, start.shape[0]
    rng = np.random.default_rng(11)
    setting = TrajOptimizerSetting(dof=d, total_step=6, total_time=3.0, epsilon=0.2,
                                   cost_sigma=0.05, obs_check_inter=inter, opt_type="lm",
                                   Qc=np.eye(d))
    f = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    s = f(start + 0.05 * rng.normal(size=(B, d)))
    g = f(goal + 0.05 * rng.normal(size=(B, d)))
    z = f(0.1 * rng.normal(size=(B, d)))
    probs = make_problem(robot, sdf, s, z, g, -z, setting, sdf_pack=False)
    line = init_traj_straight_line(probs.space, s, g, 6, 3.0)
    noise = f(0.2 * rng.normal(size=(2, B, 7, d)))
    traj = Trajectory(line.pose + noise[0], line.vel + noise[1])
    centers, Jc = _spheres_and_jac(probs.robot, _collision_confs(probs, *traj))
    got = assemble.assemble_vec_torch(*_assembly_operands(probs, *traj, centers, Jc))
    want = traj_linearize(probs, traj)
    for name, a, w in zip(("H_diag", "H_off", "b", "err"), got, want):
        scale = float(w.abs().max())
        assert scale > 0 and float((a - w).abs().max()) <= 1e-12 * scale, name

"""Each script of examples_torch/ runs to its end on the CPU (`--cpu`) in a
subprocess and exits 0; arm2_factor_graph.py and arm3_factor_graph.py also
with --dogleg, point_robot_2d.py also with --plot to a temporary file,
batch_fleet.py on two gloo ranks at 32 problems.

The scripts run one thread each, at most four at a time, from when the
first case asks for them; each case waits for its own. Every script
prints its result; the newer ones end on a `result {...}` JSON line with
a finite final error.
"""

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLOT = os.path.join(tempfile.gettempdir(), f"point_robot_2d_{os.getpid()}.png")
# the slowest first, so that four workers finish together
RUNS = {
    "point_robot_3d_rh": ["point_robot_3d_rh.py"],
    "point_robot_3d": ["point_robot_3d.py"],
    "wam_workspace_constraints": ["wam_workspace_constraints.py"],
    "mobile_arm_replanner": ["mobile_arm_replanner.py"],
    "wam_replanner": ["wam_replanner.py"],
    "wam_factor_graph": ["wam_factor_graph.py"],
    "arm2_factor_graph": ["arm2_factor_graph.py"],
    "arm2_factor_graph_dogleg": ["arm2_factor_graph.py", "--dogleg"],
    "arm3_goal_reach": ["arm3_goal_reach.py"],
    "mobile_arm2_factor_graph": ["mobile_arm2_factor_graph.py"],
    "multi_graph_point_robot": ["multi_graph_point_robot.py"],
    "wam_planner": ["wam_planner.py"],
    "save_sdf": ["save_sdf.py"],
    "arm3_factor_graph": ["arm3_factor_graph.py"],
    "arm3_factor_graph_dogleg": ["arm3_factor_graph.py", "--dogleg"],
    "arm3_joint_limit": ["arm3_joint_limit.py"],
    "arm3_planner": ["arm3_planner.py"],
    "mobile_2arms_factor_graph": ["mobile_2arms_factor_graph.py"],
    "mobile_arm_planning": ["mobile_arm_planning.py"],
    "mobile_base": ["mobile_base.py"],
    "point_robot_2d": ["point_robot_2d.py"],
    "point_robot_2d_plot": ["point_robot_2d.py", "--plot", PLOT],
    "receding_horizon": ["receding_horizon.py"],
    "batch_fleet": ["batch_fleet.py"],
}
# environment of a script's run beyond the threads: batch_fleet's two gloo
# ranks plan 32 problems (its default is 256)
ENV = {"batch_fleet": {"FLEET_BATCH": "32"}}
# what each of the older scripts prints as its result
OLDER = {"wam_factor_graph": "Final Error", "arm2_factor_graph": "Final Error",
         "arm2_factor_graph_dogleg": "Final Error", "arm3_goal_reach": "Final Error",
         "mobile_arm2_factor_graph": "Final Error", "multi_graph_point_robot": "Final Error",
         "wam_planner": "dense collision cost", "save_sdf": "round trip OK"}
MAX_RUNNING = 4


def _run(name, argv):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **ENV.get(name, {}))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples_torch", argv[0]), "--cpu", *argv[1:]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)


@pytest.fixture(scope="module")
def runs():
    pool = concurrent.futures.ThreadPoolExecutor(MAX_RUNNING)
    futures = {name: pool.submit(_run, name, argv) for name, argv in RUNS.items()}
    yield futures
    for f in futures.values():
        f.cancel()
    pool.shutdown(wait=True)
    if os.path.exists(PLOT):
        os.remove(PLOT)


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs_on_cpu(runs, name):
    out = runs[name].result()
    assert out.returncode == 0, out.stdout[-4000:]
    # every script reports its result; none fell back to a silent no-op
    if name in OLDER:
        assert OLDER[name] in out.stdout, out.stdout
        return
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("result "), out.stdout[-4000:]
    result = json.loads(last[len("result "):])
    assert math.isfinite(result["error"]) and result["iterations"] > 0, result
    if name == "point_robot_2d_plot":
        assert f"saved {PLOT}" in out.stdout and os.path.getsize(PLOT) > 0

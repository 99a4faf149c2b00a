"""Each script of examples_torch/ runs to its end on the CPU (`--cpu`) in a
subprocess and exits 0; arm2_factor_graph.py also with --dogleg.

The scripts start together, one thread each, when the first case asks for
them; each case waits for its own.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "wam_factor_graph": ["wam_factor_graph.py"],
    "arm2_factor_graph": ["arm2_factor_graph.py"],
    "arm2_factor_graph_dogleg": ["arm2_factor_graph.py", "--dogleg"],
    "arm3_goal_reach": ["arm3_goal_reach.py"],
    "mobile_arm2_factor_graph": ["mobile_arm2_factor_graph.py"],
    "multi_graph_point_robot": ["multi_graph_point_robot.py"],
    "wam_planner": ["wam_planner.py"],
    "save_sdf": ["save_sdf.py"],
}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples_torch", argv[0]), "--cpu", *argv[1:]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, argv in RUNS.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("name", list(RUNS))
def test_example_runs_on_cpu(runs, name):
    out, _ = runs[name].communicate(timeout=300)
    assert runs[name].returncode == 0, out[-4000:]
    # every script reports its result; none fell back to a silent no-op
    assert any(k in out for k in ("Final Error", "round trip OK", "dense collision cost")), out

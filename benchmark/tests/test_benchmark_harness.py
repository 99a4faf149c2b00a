"""The harness driven on the CPU at a tiny size: sound runs come out
correct, a control and each planted fault come out not correct, and a
configuration, mix, cell and metric added as files alone are found."""

import json
import os
import shutil

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(bench, cell):
    out = tiny.run(*bench, cell)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and set(out) >= {"correct", "attempted", "failed", "metrics",
                                                  "device"}
    assert list(out)[-1] == "check"
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2


def test_traced_run_reports_per_layer_metrics(bench):
    out = tiny.run(*bench, "wam7_desk.tiny", trace=True)
    assert out["correct"]
    assert {"device_idle_pct.batch", "lm_iterations_mean"} <= set(out["metrics"])
    assert "plans_per_s" not in out["metrics"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert len(out["breakdown"]["device_ops"]) <= 10


def _unchanged_step(space, traj, delta):
    return traj


def _half_left_out(plan_batch):
    """plan_batch solving the first half of the lanes; the rest keep their
    init, reported converged with the mean error of the solved half."""
    def broken(problems, init, params):
        from gpmp2_tpu_torch.planner.problem import Trajectory
        from gpmp2_tpu_torch.solver.optimize import OptResult

        B = init.pose.shape[0]
        h = max(1, B // 2)
        idx = torch.arange(h)
        res = plan_batch(problems.lanes(idx), Trajectory(init.pose[:h], init.vel[:h]), params)
        if h == B:  # one lane: leave it all out
            return OptResult(init, res.error, res.iterations, torch.ones_like(res.converged),
                             res.gave_up)
        pad = lambda t, fill: torch.cat([t, fill.expand((B - h,) + t.shape[1:])])  # noqa: E731
        return OptResult(
            Trajectory(torch.cat([res.traj.pose, init.pose[h:]]),
                       torch.cat([res.traj.vel, init.vel[h:]])),
            pad(res.error, res.error.mean()), pad(res.iterations, res.iterations[:1]),
            pad(res.converged, torch.ones((), dtype=torch.bool)),
            pad(res.gave_up, torch.zeros((), dtype=torch.bool)))
    return broken


def _answer_altered(plan_batch):
    """plan_batch whose returned trajectories move after the error is taken."""
    def broken(problems, init, params):
        res = plan_batch(problems, init, params)
        pose = res.traj.pose.clone()
        pose[:, pose.shape[1] // 2] += 0.05
        return res._replace(traj=res.traj._replace(pose=pose))
    return broken


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", ["unchanged_step", "half_left_out", "answer_altered"])
def test_planted_fault_is_not_correct(bench, monkeypatch, cell, fault):
    from gpmp2_tpu_torch import planner
    from gpmp2_tpu_torch.planner import batch

    if fault == "unchanged_step":
        monkeypatch.setattr(batch, "_retract_traj", _unchanged_step)
    else:
        wrap = _half_left_out if fault == "half_left_out" else _answer_altered
        monkeypatch.setattr(planner, "plan_batch", wrap(planner.plan_batch))
    out = tiny.run(*bench, cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell,control", [("wam7_desk.tiny", "pack_bf16"),
                                          ("wam7_desk.one", "pack_bf16"),
                                          ("mobile_se2.tiny", "reference_bf16")])
def test_control_is_not_correct(bench, monkeypatch, cell, control):
    if control == "pack_bf16":
        monkeypatch.setenv("GPMP2_TPU_PACK_DTYPE", "bfloat16")
    out = tiny.run(*bench, cell, control=None if control == "pack_bf16" else control)
    assert not out["correct"], out["check"]
    assert out["check"]["cost_gap"]["value"] > out["check"]["cost_gap"]["limit"]


def test_new_files_are_found(bench, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files, with new entries in the spec, run with no other edit."""
    base, spec = bench
    new = os.path.join(str(tmp_path), "bench")
    shutil.copytree(base, new)
    cfg = json.load(open(os.path.join(new, "configs", "mobile_se2.json")))
    cfg["setting"]["total_step"] = 8
    tiny.write(new, "configs", "mobile_short", cfg)
    tiny.write(new, "traffic", "pair", {"loop": "plan", "batch": 2, "pool": 1})
    tiny.write(new, "cells", "mobile_short.pair",
               json.load(open(os.path.join(new, "cells", "mobile_se2.tiny.json"))))
    with open(os.path.join(new, "metrics", "plans_attempted.py"), "w") as fh:
        fh.write("def read(run):\n    return run.loop.attempted()\n")
    spec = json.loads(json.dumps(spec))
    spec["configs"].append(dict(spec["configs"][1], name="mobile_short"))
    spec["workloads"].append({"name": "mobile_short.pair", "config": "mobile_short",
                              "traffic": "pair", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("mobile_short.pair")
    spec["per_layer"].append({"name": "plans_attempted", "unit": "plans", "better": "higher",
                              "source": "program_counter", "layer": "planner entry",
                              "moves": "plans_per_s", "workloads": ["mobile_short.pair"]})
    out = tiny.run(new, spec, "mobile_short.pair", trace=True)
    assert out["correct"]
    assert out["metrics"]["plans_attempted"]["value"] == out["attempted"]
    # a metric whose `workloads` leave the new cell out is not read there
    assert set(out["metrics"]) == {"plans_attempted"}

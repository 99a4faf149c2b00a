"""The port's recorder of spans and counters (gpmp2_tpu_torch/utils/trace.py)
on a batch of point-robot plans beside one block, on the CPU:

- with spans off a plan_batch records nothing and makes the same host
  reads; its result is bit-identical to a traced call's;
- the span tree of a call: children inside their parents, one stop test
  and one linearize an attempt, the initial linearize and the test that
  ends the loop under the call, the float64 rescue inside the call;
- `lanes_active` against the active counts that verbosity='error' prints;
- under torch.profiler the spans record with no other switch, each stop
  test around the profiler's host read of the count (one clock);
- the bounded buffer and its count of dropped spans;
- the launch counters (the card's counts: tests/test_torch_kernels_cuda.py).
"""

import collections
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
from gpmp2_tpu_torch.kinematics import PointRobotFK, make_robot_model
from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                     make_problem, optimizer_params_from_setting, plan_batch)
from gpmp2_tpu_torch.utils import trace

B = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def batch():
    """B point-robot problems across a 1 x 1 m block in a 4 m square field
    (5 cm cells), float32, and the LM parameters of their setting."""
    occ = np.zeros((80, 80))
    occ[35:55, 30:50] = 1.0
    sdf = planar_sdf_from_occupancy(np.array([-2.0, -2.0]), 0.05, occ, dtype=torch.float32,
                                    device=CPU)
    robot = make_robot_model(PointRobotFK(), [(0, 0.1, (0.0, 0.0, 0.0))],
                             dtype=torch.float32, device=CPU)
    setting = TrajOptimizerSetting(dof=2, total_step=10, total_time=10.0, epsilon=0.2,
                                   cost_sigma=0.1, obs_check_inter=3, opt_type="lm",
                                   max_iter=100, rel_thresh=1e-5, Qc=np.eye(2))
    g = torch.Generator().manual_seed(7)
    start = torch.tensor([-1.5, -1.2]) + 0.2 * torch.randn(B, 2, generator=g)
    goal = torch.tensor([1.5, 1.4]) + 0.2 * torch.randn(B, 2, generator=g)
    zero = torch.zeros(B, 2)
    probs = make_problem(robot, sdf, start, zero, goal, zero, setting)
    init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                   setting.total_step, setting.total_time)
    return probs, init, optimizer_params_from_setting(setting)


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.enable(None)
    trace.clear()
    yield
    trace.enable(None)
    trace.clear()


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip((*a.traj, *a[1:]), (*b.traj, *b[1:])))


def _host_reads(monkeypatch):
    """Counts of the tensor-to-Python reads (each a host sync on a card)."""
    reads = collections.Counter()
    for name in ("__bool__", "__int__", "__float__", "item"):
        orig = getattr(torch.Tensor, name)

        def counted(self, _orig=orig, _name=name):
            reads[_name] += 1
            return _orig(self)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


def _traced(batch, params=None):
    trace.enable(True)
    res = plan_batch(batch[0], batch[1], params or batch[2])
    trace.enable(None)
    return res, trace.spans()


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s[0]].append(s)
    return out


def test_spans_off_record_nothing_and_results_match(batch, monkeypatch):
    counters = trace.counters()
    reads = _host_reads(monkeypatch)
    trace.enable(False)
    off = plan_batch(*batch)
    off_reads = sum(reads.values())
    assert trace.spans() == [] and trace.dropped() == 0
    reads.clear()
    on, spans = _traced(batch)
    assert _equal(off, on)
    # tracing adds no host read: one stop test an attempt and the one
    # that ends the loop
    root = _by_name(spans)["plan_batch"][0]
    assert sum(reads.values()) == off_reads == root[6]["attempts"] + 1
    assert trace.counters() == counters


def test_span_tree(batch):
    res, spans = _traced(batch)
    names = _by_name(spans)
    (root,) = names["plan_batch"]
    by_id = {s[3]: s for s in spans}
    assert len(by_id) == len(spans)
    assert {s[5] for s in spans} == {root[3]} and root[4] is None
    for s in spans:
        assert s[1] <= s[2]
        if s[4] is not None:
            parent = by_id[s[4]]
            assert parent[1] <= s[1] and s[2] <= parent[2], (s, parent)
    attempts = names["attempt"]
    a = root[6]
    assert a["attempts"] == len(attempts) >= int(res.iterations.max()) > 0
    assert a["lanes_offered"] == B * len(attempts)
    assert all(by_id[s[4]][0] == "plan_batch" for s in attempts)
    # one stop test and one linearize an attempt, under it; the initial
    # linearize and the stop test that ends the loop under the call
    for kind in ("stop_test", "linearize"):
        under = collections.Counter(by_id[s[4]][0] for s in names[kind])
        assert under == {"attempt": len(attempts), "plan_batch": 1}, kind
        assert len({s[4] for s in names[kind] if s[4] != root[3]}) == len(attempts)
    assert a["lanes_active"] == sum(s[6]["active"] for s in attempts)
    assert attempts[0][6]["active"] == B and attempts[-1][6]["active"] > 0


def test_lanes_active_match_the_verbosity_trace(batch, capfd):
    params = dataclasses.replace(batch[2], verbosity="error")
    capfd.readouterr()
    _, spans = _traced(batch, params)
    printed = [int(n) for n in re.findall(r"active (\d+) converged", capfd.readouterr().out)]
    names = _by_name(spans)
    root = names["plan_batch"][0][6]
    assert printed == [s[6]["active"] for s in names["attempt"]]
    assert root["lanes_active"] == sum(printed) and len(printed) == root["attempts"]


def test_rescue_runs_inside_its_call(batch):
    """A float64 rescue of lanes that gave up (LM's lambda capped low) adds
    its attempts to the one call, each offering only the rescued lanes."""
    params = dataclasses.replace(batch[2], lambda_max=1e3, rescue_f64=True)
    rescued = int(plan_batch(batch[0], batch[1],
                             dataclasses.replace(params, rescue_f64=False)).gave_up.sum())
    assert 0 < rescued < B
    res, spans = _traced(batch, params)
    names = _by_name(spans)
    (root,) = names["plan_batch"]
    attempts = names["attempt"]
    # the solve's initial linearize, then the rescue's: both under the call
    first, second = sorted(s[1] for s in names["linearize"] if s[4] == root[3])
    solve = [s for s in attempts if s[1] < second]
    rescue = [s for s in attempts if s[1] > second]
    assert solve and rescue and len(solve) + len(rescue) == len(attempts)
    assert solve[0][6]["active"] == B and rescue[0][6]["active"] == rescued
    assert root[6]["attempts"] == len(attempts)
    assert root[6]["lanes_offered"] == B * len(solve) + rescued * len(rescue)
    assert len(names["linearize"]) == len(attempts) + 2
    assert {s[5] for s in spans} == {root[3]}
    off = plan_batch(batch[0], batch[1], params)
    assert _equal(off, res)


def test_profiler_turns_spans_on_and_shares_their_clock(batch):
    plan_batch(*batch)
    assert trace.spans() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan_batch(*batch)
    spans = trace.spans()
    reads = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name() in ("aten::_local_scalar_dense", "aten::is_nonzero")]
    tests = _by_name(spans)["stop_test"]
    assert tests and _by_name(spans)["plan_batch"]
    for _, c, d, *_ in tests:
        assert any(c <= a and b <= d for a, b in reads), (c, d)
    trace.clear()
    trace.enable(False)
    with profile(activities=[ProfilerActivity.CPU]):
        plan_batch(*batch)
    assert trace.spans() == []


def test_buffer_is_bounded_and_counts_what_it_drops(batch, monkeypatch):
    _, full = _traced(batch)
    trace.clear()
    monkeypatch.setattr(trace, "_buffer", collections.deque(maxlen=10))
    _, kept = _traced(batch)
    assert len(kept) == 10 and trace.dropped() == len(full) - 10
    assert [s[0] for s in kept] == [s[0] for s in full[-10:]]
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_launch_counters(batch):
    """The three kernels' counters are always there; the plain versions
    (CPU tensors) launch nothing; reset_counters zeroes them."""
    names = ("launches.k1", "launches.k2", "launches.k3")
    assert set(names) <= set(trace.counters())
    before = trace.counters()
    plan_batch(*batch)
    assert trace.counters() == before
    trace.count("launches.k2")
    trace.count("launches.k2")
    assert trace.counters()["launches.k2"] == before["launches.k2"] + 2
    trace.reset_counters()
    assert all(trace.counters()[n] == 0 for n in names)

"""The readers of the port's own spans (benchmark/spans.py and the five
metrics that call it): exact values on a hand-made window, None where the
port has no recorder, and numbers in range on tiny traced CPU runs."""

import importlib.util
import os
import sys

import pytest

import gpmp2_tpu_torch.utils
from benchmark import harness, spans
from benchmark.tests import tiny
from gpmp2_tpu_torch.utils import trace as program

METRICS = {"lanes_active_pct": 75.0, "stop_test_wait_pct": 100.0 * 240 / 900,
           "linearize_host_ms": 80 / 1e6, "dispatch_idle_pct.batch": 40.0,
           "dispatch_idle_pct.single": 40.0}
PERCENT = {name for name in METRICS if name.endswith("_pct") or "_pct." in name}


def _reader(name):
    path = os.path.join(harness.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# one call (id 1) of B = 4 in a window of 1000 ns: the initial linearize,
# two attempts (ids 3, 6), each a stop test and a linearize, and the stop
# test that ends the loop; then a call (id 20) that ends past the window
WINDOW = [
    ("linearize", 10, 50, 2, 1, 1, None),
    ("stop_test", 60, 120, 4, 3, 1, None),
    ("linearize", 200, 300, 5, 3, 1, None),
    ("attempt", 60, 400, 3, 1, 1, {"active": 4}),
    ("stop_test", 400, 500, 7, 6, 1, None),
    ("linearize", 600, 700, 8, 6, 1, None),
    ("attempt", 400, 800, 6, 1, 1, {"active": 2}),
    ("stop_test", 800, 880, 9, 1, 1, None),
    ("plan_batch", 0, 900, 1, None, 1, {"attempts": 2, "lanes_active": 6, "lanes_offered": 8}),
    ("linearize", 950, 990, 21, 20, 20, None),
    ("plan_batch", 940, 1200, 20, None, 20,
     {"attempts": 0, "lanes_active": 0, "lanes_offered": 0}),
]


class FakeRun:
    traced_ns = (0, 1000)
    ops = [("k", 100, 200), ("k", 450, 600), ("k", 580, 590)]


def _program(monkeypatch, records):
    monkeypatch.setattr(program, "spans", lambda: list(records))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_on_a_hand_made_window(monkeypatch, name):
    _program(monkeypatch, WINDOW)
    assert _reader(name)(FakeRun()) == pytest.approx(METRICS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_finds_nothing_without_the_recorder(monkeypatch, name):
    """A port without utils/trace.py (the parent of this reader), and a
    window with no whole plan_batch call: None, no exception."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "gpmp2_tpu_torch.utils.trace", None)
        m.delattr(gpmp2_tpu_torch.utils, "trace")
        assert _reader(name)(FakeRun()) is None
    _program(monkeypatch, WINDOW[-2:])
    assert _reader(name)(FakeRun()) is None


def test_overlap_of_interval_lists():
    busy = [[0, 5], [8, 12], [20, 30]]
    assert spans._overlap_ns([(1, 9), (10, 25), (40, 50)], busy) == 4 + 1 + 2 + 5


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["wam7_desk.tiny", "wam7_desk.one"])
def test_traced_tiny_run_reports_the_span_metrics(bench, cell):
    base, spec = bench
    out = tiny.run(base, spec, cell, trace=True)
    want = {m["name"] for m in harness.metrics_of(spec, cell, True)} & set(METRICS)
    assert want and want <= set(out["metrics"]), out["metrics"]
    for name in want:
        value = out["metrics"][name]["value"]
        assert (0.0 <= value <= 100.0) if name in PERCENT else value > 0.0, (name, value)

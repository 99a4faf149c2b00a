"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and a file for every configuration, mix, cell and metric."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 << 10


def test_names_and_units_use_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_has_its_files_and_metrics(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert config["file"] == f"benchmark/configs/{w['config']}.json"
    for path in (config["file"], f"benchmark/traffic/{w['traffic']}.json",
                 f"benchmark/cells/{cell}.json"):
        assert os.path.exists(os.path.join(harness.ROOT, path)), path
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, False)]
    per_layer = harness.metrics_of(SPEC, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in harness.metrics_of(SPEC, cell, False) + per_layer:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))
    assert all(m["moves"] in e2e for m in per_layer)
    limits = harness.load_json(os.path.join(harness.BENCH, "cells", cell + ".json"))["limits"]
    assert set(limits) == {"cost_gap", "unsolved_share"}


def test_every_config_is_used_and_names_its_roofline_metrics():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"

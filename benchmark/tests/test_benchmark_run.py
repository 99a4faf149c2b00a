"""run.py refuses to run without a card, and in a checkout that holds
only the benchmark, and prints no result either way."""

import os
import shutil
import subprocess
import sys

from benchmark import harness

ARGS = ["--workload", "wam7_desk.batch2048", "--seed", "2147483700", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_exits_nonzero_without_a_card():
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA device" in out.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""

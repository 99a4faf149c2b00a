"""No module of JAX or of the JAX package is loaded by the harness, and
the reference loads nothing of the port. Each import runs in a fresh
interpreter; names are compared whole, by their top-level part."""

import json
import os
import subprocess
import sys

from benchmark import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for m in {modules!r}:
    __import__(m)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _loaded(modules):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=harness.ROOT,
                                                            modules=modules)],
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    modules = ["benchmark.harness", "benchmark.loops.plan", "benchmark.draws",
               "benchmark.roofline", "benchmark.trace", "benchmark.robots.dh_arm",
               "benchmark.robots.se2_base", "benchmark.reference.judge",
               "gpmp2_tpu_torch.planner", "gpmp2_tpu_torch.utils.convert",
               "gpmp2_tpu_torch.datasets"]
    loaded = _loaded(modules)
    assert "gpmp2_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded(["benchmark.reference.judge", "benchmark.reference.dh_arm",
                      "benchmark.reference.se2_base", "benchmark.reference.datasets",
                      "benchmark.reference.field", "benchmark.reference.gp"])
    assert not loaded & ({"gpmp2_tpu_torch"} | set(harness.FORBIDDEN))

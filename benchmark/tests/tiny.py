"""Cells of the benchmark at a size a CPU test run holds: the production
configurations with the WAM desk and MobileMap1 at 5 cm cells (60^3 and
299^2) and batches of a few plans; each cell keeps its production limits."""

import copy
import json
import os
import shutil
import time

import torch

from benchmark import harness

CELLS = {  # tiny cell -> (production cell, traffic)
    "wam7_desk.tiny": ("wam7_desk.batch2048", {"loop": "plan", "batch": 6, "pool": 2}),
    "mobile_se2.tiny": ("mobile_se2.batch4096", {"loop": "plan", "batch": 4, "pool": 2}),
    "wam7_desk.one": ("wam7_desk.single", {"loop": "plan", "batch": 1, "pool": 4}),
}


def make_base(tmp):
    """A benchmark folder under `tmp` holding the tiny cells; returns
    (base, spec)."""
    base = os.path.join(str(tmp), "bench")
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    shutil.copytree(os.path.join(harness.BENCH, "metrics"), os.path.join(base, "metrics"))
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    for name in ("wam7_desk", "mobile_se2"):
        cfg = harness.load_json(os.path.join(harness.BENCH, "configs", name + ".json"))
        if name == "wam7_desk":
            f = cfg["field"]
            f["shape"], f["cell_size"] = [60, 60, 60], 0.05
            f["boxes_cells"] = [[[p // 5 for p in pos], [max(1, s // 5) for s in size]]
                                for pos, size in f["boxes_cells"]]
            cfg["setting"]["obs_check_inter"] = 3
        else:
            f = cfg["field"]
            f["shape"], f["cell_size"] = [299, 299], 0.05
        write(base, "configs", name, cfg)
    rename = {}
    for tiny, (prod, traffic) in CELLS.items():
        write(base, "traffic", tiny.split(".")[1], traffic)
        write(base, "cells", tiny, dict(harness.load_json(
            os.path.join(harness.BENCH, "cells", prod + ".json")), sample=4))
        rename[prod] = tiny
    spec = copy.deepcopy(spec)
    for w in spec["workloads"]:
        w["traffic"] = rename[w["name"]].split(".")[1]
        w["name"] = rename[w["name"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    return base, spec


def write(base, sub, name, obj):
    with open(os.path.join(base, sub, name + ".json"), "w") as fh:
        json.dump(obj, fh)


def run(base, spec, cell, seed=2**31 + 5, seconds=0.3, trace=False, control=None):
    """One run of a tiny cell on the CPU (the harness's look for a card
    skipped)."""
    return harness.execute(spec, cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), base=base, control=control)


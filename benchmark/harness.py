"""One run of one cell: set-up, the measured window, the metrics, the
check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
metric sits in a file of its own under the benchmark's folder, found by
the name BENCHMARK.json gives it:
- configs/<config>.json: the deployment (robot tables, the field's
  boxes, the setting, the endpoint draw); robots/<kind>.py builds the
  port's robot from it, reference/<kind>.py the reference's;
- traffic/<mix>.json: the loop's parameters; loops/<loop>.py drives it;
- cells/<cell>.json: the judged sample's size and each compared number's
  limit;
- metrics/<metric>.py: the reader of one metric, `read(run)`, which
  returns a number or None where it finds nothing to read.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import resource
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level modules that no run may load (the JAX package beside the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpmp2_tpu")
# a traced run profiles the first this many seconds of its window, which
# bounds the profiler's records (a WAM request launches ~4,000 kernels)
TRACE_SECONDS = 10.0


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metrics_of(spec, cell, trace):
    """The metric entries a run of `cell` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    if trace:
        reported = {m["name"] for m in metrics_of(spec, cell, False)}
        return [m for m in group if cell in m.get("workloads", [cell])
                and ("workloads" in m or m["moves"] in reported)]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Run:
    """The state of one run, which loops and metric readers read."""

    def __init__(self, spec, cell, seed, seconds, trace, device, t_start, base=BENCH):
        entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
        if entry is None:
            raise SystemExit(f"benchmark: no workload {cell!r} in BENCHMARK.json")
        self.spec, self.cell, self.base = spec, entry, base
        self.config = load_json(os.path.join(base, "configs", entry["config"] + ".json"))
        self.traffic = load_json(os.path.join(base, "traffic", entry["traffic"] + ".json"))
        self.check = load_json(os.path.join(base, "cells", cell + ".json"))
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.parts = {}  # set-up part -> seconds
        self.spans = []  # (name, start ns, end ns) on time.time_ns
        self.requests = []  # one dict a request of the window
        self.ops = None  # the device's operations in the traced window
        self.window_ns = None
        self.traced_ns = None
        self.setup_s = None

    @contextlib.contextmanager
    def part(self, name):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.time_ns()
        yield
        self.spans.append((name, t0, time.time_ns()))

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def traced_s(self):
        return (self.traced_ns[1] - self.traced_ns[0]) / 1e9


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def cpu_mhz():
    """The mean clock of the host's cores as /proc/cpuinfo gives it, or None."""
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh if line.startswith("cpu MHz")]
    except OSError:
        return None
    return round(sum(mhz) / len(mhz), 1) if mhz else None


def device_info(device):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def stop_trace(run, prof):
    """Stop the profiler and keep the traced window's device operations."""
    from . import trace as tr

    t = time.perf_counter()
    run.sync()
    prof.stop()
    run.ops = tr.device_ops(prof, run.device, *run.traced_ns)
    log(f"traced {run.traced_s:.3f} s: {len(run.ops)} device operations, read in "
        f"{time.perf_counter() - t:.3f} s")
    return None


def execute(spec, cell, seed, seconds, trace, device, t_start, base=BENCH, control=None):
    """One run; returns the result line as a dict (see run.py)."""
    run = Run(spec, cell, seed, seconds, trace, device, t_start, base)
    loop = importlib.import_module(f"benchmark.loops.{run.traffic['loop']}").Loop(run)
    run.loop = loop
    loop.setup()
    with run.part("warm-up"):
        loop.warm()
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in run.parts.items())
        + f"; host peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")

    from . import trace as tr

    # the set-up's objects (the pools, the fields' host copies) move to the
    # collector's permanent generation, so its passes in the window scan
    # only what the window makes
    gc.collect()
    gc.freeze()
    prof = tr.start(device) if trace else None
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.time_ns()
    i = 0
    while time.time_ns() - t0 < seconds * 1e9:
        run.requests.append(loop.request(i))
        i += 1
        if prof is not None and time.time_ns() - t0 >= TRACE_SECONDS * 1e9:
            run.traced_ns = (t0, time.time_ns())
            prof = stop_trace(run, prof)
    run.window_ns = (t0, time.time_ns())
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    if prof is not None:
        run.traced_ns = run.window_ns
        prof = stop_trace(run, prof)
    info = device_info(device)
    lat = sorted(r["latency_s"] * 1e3 for r in run.requests)
    log(f"window {run.window_s:.3f} s, {len(run.requests)} requests, "
        f"{loop.attempted()} plans, {loop.failed()} failed; request ms min {lat[0]:.2f}, "
        f"median {lat[len(lat) // 2]:.2f}, max {lat[-1]:.2f}; first "
        f"{[round(r['latency_s'] * 1e3, 1) for r in run.requests[:4]]}")
    log(f"window host: cpu user {use1.ru_utime - use0.ru_utime:.3f} s, sys "
        f"{use1.ru_stime - use0.ru_stime:.3f} s, involuntary switches "
        f"{use1.ru_nivcsw - use0.ru_nivcsw}, load {os.getloadavg()}, cpu MHz {cpu_mhz()}")

    metrics = {}
    for m in metrics_of(spec, cell, trace):
        reader = load_module(os.path.join(base, "metrics", m["name"] + ".py"),
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": False, "attempted": loop.attempted(), "failed": loop.failed(),
           "metrics": metrics, "device": info}
    if trace:
        out["device"]["busy_s"] = tr.busy_s(run.ops)
        out["device"]["window_s"] = run.traced_s
        out["breakdown"] = {"device_ops": tr.top_ops(run.ops),
                            "idle_gaps": tr.idle_gaps(run.ops, run.spans, *run.traced_ns)}

    loop.release()
    t_judge = time.perf_counter()
    numbers = loop.judge(control)
    log(f"reference judged the sample in {time.perf_counter() - t_judge:.3f} s; host peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    limits = run.check["limits"]
    check = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    out["correct"] = (loop.attempted() > 0 and set(numbers) == set(limits)
                      and all(v <= limits[k] for k, v in numbers.items()))
    for k, v in check.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    out["check"] = check
    return out

"""The device trace of a measured window: the intervals in which an
operation ran on the device, read from torch.profiler, and what they add
up to."""

import re


def start(device):
    """A started profiler that records the device's operations only (no
    host operator events, so the host runs as it runs untraced)."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    prof = profile(activities=[act])
    prof.start()
    return prof


def device_ops(prof, device, t0_ns, t1_ns):
    """[(name, start_ns, end_ns)] of the device's operations, clipped to
    the window [t0_ns, t1_ns] (the profiler's clock is the host's
    time.time_ns)."""
    want = "CUDA" if device.type == "cuda" else "CPU"
    out = []
    for e in prof.profiler.kineto_results.events():
        if want not in str(e.device_type()):
            continue
        a, b = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
        if b > a:
            out.append((e.name(), a, b))
    return out


def union(ops):
    """The merged busy intervals [(start_ns, end_ns)] of `ops`, in order."""
    merged = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(ops):
    return sum(b - a for a, b in union(ops)) / 1e9


def idle_pct(run):
    """Share of a run's traced window in which no operation ran on the
    device, in percent."""
    return 100.0 * (1.0 - busy_s(run.ops) / run.traced_s)


def short_name(name):
    """A kernel's name without its argument list (and without the
    anonymous namespaces, whose parentheses would cut it short)."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()


def top_ops(ops, k=10):
    """The k device operations that took most time: [[name, seconds]]."""
    total = {}
    for name, a, b in ops:
        key = short_name(name)
        total[key] = total.get(key, 0) + (b - a)
    return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(ops, spans, t0_ns, t1_ns, k=10):
    """The k longest gaps in which the device ran nothing, each named by
    the benchmark's host span open at its middle: [[span, seconds]]."""
    edges = [t0_ns] + [x for iv in union(ops) for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:k]:
        mid = (a + b) // 2
        name = next((s for s, c, d in spans if c <= mid <= d), "between requests")
        out.append([name, (b - a) / 1e9])
    return out


def matching(ops, pattern):
    """(launches, device seconds) of the operations whose name matches the
    regular expression `pattern`."""
    rx = re.compile(pattern)
    hits = [b - a for name, a, b in ops if rx.search(name)]
    return len(hits), sum(hits) / 1e9

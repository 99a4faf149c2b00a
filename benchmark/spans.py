"""The port's own spans of a traced window (gpmp2_tpu_torch/utils/trace.py),
which it records for every plan_batch call made while the profiler runs,
on the profiler's clock (time.time_ns).

Each reader returns None where it finds nothing: with a port that has no
recorder, or no plan_batch span in the window."""

from benchmark import trace


def calls(run):
    """{call_id: [span, ...]} of the plan_batch calls that lie whole in the
    traced window, each span (name, start_ns, end_ns, span_id, parent_id,
    call_id, attrs); None where there is none."""
    try:
        from gpmp2_tpu_torch.utils import trace as program
    except ImportError:
        return None
    t0, t1 = run.traced_ns
    records = program.spans()
    inside = {s[5] for s in records if s[0] == "plan_batch" and t0 <= s[1] and s[2] <= t1}
    out = {}
    for s in records:
        if s[5] in inside:
            out.setdefault(s[5], []).append(s)
    return out or None


def named(calls_, name):
    return [s for spans in calls_.values() for s in spans if s[0] == name]


def total_ns(spans):
    return sum(s[2] - s[1] for s in spans)


def lanes_active_pct(run):
    """100 x the lanes active at the stop tests over the lanes the attempts
    ran on (a float64 rescue's attempts run on the lanes that gave up),
    summed over the window's calls."""
    found = calls(run)
    if found is None:
        return None
    roots = [s[6] for s in named(found, "plan_batch") if s[6]["lanes_active"] is not None]
    offered = sum(a["lanes_offered"] for a in roots)
    return 100.0 * sum(a["lanes_active"] for a in roots) / offered if offered else None


def stop_test_wait_pct(run):
    """The window's stop-test spans over its plan_batch spans, in percent:
    the share of the call in which the host waits on the device."""
    found = calls(run)
    if found is None:
        return None
    return 100.0 * total_ns(named(found, "stop_test")) / total_ns(named(found, "plan_batch"))


def linearize_host_ms(run):
    """Mean host milliseconds of a linearize span in the window's calls."""
    found = calls(run)
    lin = named(found, "linearize") if found is not None else []
    return total_ns(lin) / len(lin) / 1e6 if lin else None


def _overlap_ns(intervals, busy):
    """Length of the sorted, disjoint `intervals` that the sorted, disjoint
    `busy` intervals cover."""
    out, j = 0, 0
    for a, b in intervals:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            out += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return out


def dispatch_idle_pct(run):
    """Share of the traced window, in percent, in which the device runs
    nothing while the host is inside an optimizer attempt and outside its
    stop test: the idle time that the host's dispatch of an attempt
    causes."""
    found = calls(run)
    if found is None:
        return None
    tests = {s[4]: s for s in named(found, "stop_test")}
    dispatch = []
    for a in sorted(named(found, "attempt"), key=lambda s: s[1]):
        t = tests.get(a[3])
        dispatch += [(a[1], t[1]), (t[2], a[2])] if t is not None else [(a[1], a[2])]
    dispatch = [iv for iv in dispatch if iv[1] > iv[0]]
    idle = sum(b - a for a, b in dispatch) - _overlap_ns(dispatch, trace.union(run.ops))
    return 100.0 * idle / (run.traced_ns[1] - run.traced_ns[0])

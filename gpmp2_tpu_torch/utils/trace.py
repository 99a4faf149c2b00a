"""The port's in-program spans and counters: one process-global recorder.

A span is the tuple (name, start_ns, end_ns, span_id, parent_id, call_id,
attrs). Its stamps come from `time.time_ns`, the clock on which
torch.profiler stamps its host and device events, so a span can be laid
over a device trace. `parent_id` is the span that caused it (None for a
call's root), `call_id` is shared by every span of one `plan_batch` call,
and `attrs` is None or a small dict of counts taken at its end. Spans are
appended as they end (a child before its parent) to a buffer of at most
CAPACITY records, which drops its oldest first and counts what it drops.

Spans are recorded per `plan_batch` call: `begin` decides once a call
whether to record it, and every span site reads `current` (None when the
call is not recorded) and branches, which is all that tracing off costs.
The decision: `enable(True)` or GPMP2_TORCH_TRACE=1 records every call,
`enable(False)` or GPMP2_TORCH_TRACE=0 none, and otherwise a call is
recorded while a torch.profiler session is active on this thread. The
variable is read when the module is imported; `enable(None)` returns to
it. The recorder follows one thread: a `plan_batch` started on another
thread while a call is recorded joins that call.

Counters are always on: integers under a name, such as `launches.k1`,
`launches.k2`, `launches.k3` and `launches.assemble`, the launches of the
hand-written CUDA kernels K1 (ops/btsolve.py), K2 (ops/fk_arm.py), K3
(ops/sdf_lookup.py) and the assembly kernel (ops/assemble.py), which
counts how often a linearize takes its route.
"""

from __future__ import annotations

import collections
import itertools
import os
import time

import torch

__all__ = ["CAPACITY", "Call", "begin", "clear", "count", "counters", "current", "dropped",
           "enable", "end", "reset_counters", "spans"]

CAPACITY = 1 << 20
KERNEL_COUNTERS = ("launches.k1", "launches.k2", "launches.k3", "launches.assemble")

_mode = {"1": True, "0": False}.get(os.environ.get("GPMP2_TORCH_TRACE", ""))
_env_mode = _mode
_buffer = collections.deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_counters = dict.fromkeys(KERNEL_COUNTERS, 0)

# the recorder of the plan_batch call being recorded, or None
current = None


def _append(record):
    global _dropped
    if len(_buffer) == _buffer.maxlen:
        _dropped += 1
    _buffer.append(record)


class Call:
    """The open spans and counts of one recorded `plan_batch` call."""

    __slots__ = ("root", "t0", "attempts", "lanes_active", "lanes_offered")

    def __init__(self):
        # the root span's id is the call's id
        self.root, self.t0 = self.open()
        self.attempts = 0
        self.lanes_active = 0  # None once an attempt's count is absent
        self.lanes_offered = 0

    @staticmethod
    def open():
        """A new span's (span_id, start_ns)."""
        return next(_ids), time.time_ns()

    def close(self, name, opened, parent, attrs=None):
        """Record the span `opened` (from `open`) as ending now."""
        _append((name, opened[1], time.time_ns(), opened[0], parent, self.root, attrs))

    def attempt(self, opened, active, lanes):
        """Record an optimizer attempt over `lanes` problems, `active` of
        them active at its stop test (None where the count was not read)."""
        self.close("attempt", opened, self.root, {"active": active})
        self.attempts += 1
        self.lanes_offered += lanes
        self.lanes_active = (None if active is None or self.lanes_active is None
                             else self.lanes_active + active)


def enable(mode=True):
    """Record every plan_batch call (True), none (False), or follow
    GPMP2_TORCH_TRACE and else the profiler (None)."""
    global _mode
    _mode = _env_mode if mode is None else bool(mode)


def begin():
    """Open a recorded call, or None: when spans are off, or when a call is
    already open (plan_batch's float64 rescue runs inside its call)."""
    global current
    if current is not None:
        return None
    if not (_mode if _mode is not None else torch._C._autograd._profiler_enabled()):
        return None
    current = Call()
    return current


def end(call):
    """Close the call `call` (from `begin`)."""
    global current
    current = None
    call.close("plan_batch", (call.root, call.t0), None,
               {"attempts": call.attempts, "lanes_active": call.lanes_active,
                "lanes_offered": call.lanes_offered})


def spans():
    """The recorded spans, oldest first by end."""
    return list(_buffer)


def dropped():
    """Spans dropped from the full buffer since the last `clear`."""
    return _dropped


def clear():
    global _dropped
    _buffer.clear()
    _dropped = 0


def count(name):
    _counters[name] = _counters.get(name, 0) + 1


def counters():
    return dict(_counters)


def reset_counters():
    for name in _counters:
        _counters[name] = 0

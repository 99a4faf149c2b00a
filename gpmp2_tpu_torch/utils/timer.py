"""Wall-clock timer with tic/toc and accumulation.

Port of gpmp2_tpu/utils/timer.py (gpmp2::Timer, utils/Timer.h:84-140) on
time.perf_counter_ns. PyTorch returns before the card finishes, so `toc`
takes the tensors the timed section produced and synchronizes their CUDA
devices first (where the JAX package blocks on its arrays); without them
it measures the host's enqueue.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Timer"]


def _cuda_devices(xs):
    """The CUDA devices of the tensors in `xs`, nested tuples and lists
    (NamedTuple results) included."""
    out = set()
    for x in xs:
        if torch.is_tensor(x):
            if x.is_cuda:
                out.add(x.device)
        elif isinstance(x, (tuple, list)):
            out |= _cuda_devices(x)
    return out


class Timer:
    def __init__(self, name: str = ""):
        self.name = name
        self._t0 = None
        self._acc_us = 0
        self._last_us = 0

    def tic(self):
        self._t0 = time.perf_counter_ns()

    def toc(self, *block_on) -> int:
        """Stop; returns microseconds. Pass the timed section's tensors (or
        tuples of them) to wait for their devices."""
        for dev in _cuda_devices(block_on):
            torch.cuda.synchronize(dev)
        self._last_us = (time.perf_counter_ns() - self._t0) // 1000
        self._acc_us += self._last_us
        return self._last_us

    def acc_us(self) -> int:
        return self._acc_us

    def reset(self):
        self._acc_us = 0
        self._last_us = 0

    def print(self):
        print(f"{self.name}: {self._last_us} us (acc {self._acc_us} us)")

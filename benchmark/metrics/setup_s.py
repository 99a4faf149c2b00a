"""Seconds from the process's start to the measured window: imports,
kernel build or load, fields, draws, packing and warm-up (host clock)."""


def read(run):
    return run.setup_s

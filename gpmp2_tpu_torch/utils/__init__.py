"""Utilities: file IO, timing, interop (port of gpmp2_tpu/utils; plotting
is not ported). `utils.convert` builds the port's objects from numpy."""

from .fileio import load_sdf, load_trajectory, read_sdf_vol_file, save_sdf, save_trajectory
from .interop import buffer_to_trajectory, trajectory_to_buffer
from .timer import Timer

__all__ = ["save_sdf", "load_sdf", "read_sdf_vol_file", "save_trajectory", "load_trajectory",
           "Timer", "trajectory_to_buffer", "buffer_to_trajectory"]

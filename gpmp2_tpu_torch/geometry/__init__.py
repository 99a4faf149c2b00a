"""Lie-group geometry (port of gpmp2_tpu/geometry): SE(2), the parts of
SO(3) and SE(3) the FK and the workspace priors use, and the state spaces.
The SE(3) state space and `Pose3`'s export wait for the `se3` kind."""

from . import se2, se3, so3
from .statespace import SE2Space, SE2VectorSpace, StateSpace, VectorSpace

__all__ = ["se2", "se3", "so3", "StateSpace", "VectorSpace", "SE2Space", "SE2VectorSpace"]

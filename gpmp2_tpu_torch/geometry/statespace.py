"""Configuration-space descriptor (port of gpmp2_tpu/geometry/statespace.py).

The vector space R^d of the arm families and the point robot, and SE(2)
(gtsam::Pose2, stored [x, y, theta], tangent [vx, vy, omega]) of the
mobile base. The SE(2) x R^n and SE(3) spaces of the mobile manipulators
come with a later slice. Chart operations take tensors with any leading
dimensions.
"""

from __future__ import annotations

import dataclasses

from . import se2

__all__ = ["StateSpace", "VectorSpace", "SE2Space"]


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """Static descriptor of a configuration space.

    kind: 'vector' | 'se2'; dim: tangent dimension (the robot's dof)."""

    kind: str
    dim: int

    def __post_init__(self):
        if self.kind not in ("vector", "se2"):
            raise ValueError(f"unknown state space kind {self.kind!r}")

    @property
    def is_vector(self) -> bool:
        return self.kind == "vector"

    def retract(self, x, delta):
        """Right retraction x * Exp(delta) (exact exp)."""
        return x + delta if self.is_vector else se2.retract(x, delta)

    def local(self, x, y):
        """Log(x^-1 y): the tangent of y in the chart centred at x."""
        return y - x if self.is_vector else se2.local(x, y)

    def compose(self, x, y):
        return x + y if self.is_vector else se2.compose(x, y)

    def inverse(self, x):
        return -x if self.is_vector else se2.inverse(x)

    def expmap(self, delta):
        return delta if self.is_vector else se2.expmap(delta)

    def logmap(self, x):
        return x if self.is_vector else se2.logmap(x)

    def interpolate_linear(self, x, y, alpha):
        """Chart interpolation x * Exp(alpha * Log(x^-1 y)); a lerp on a
        vector space (initPose2TrajStraightLine, TrajUtils.cpp:76-93)."""
        return self.retract(x, alpha * self.local(x, y))


def VectorSpace(d: int) -> StateSpace:
    return StateSpace("vector", d)


def SE2Space() -> StateSpace:
    return StateSpace("se2", 3)

"""Configuration-space descriptor (port of gpmp2_tpu/geometry/statespace.py).

The vector space R^d of the arm families and the point robot, SE(2)
(gtsam::Pose2, stored [x, y, theta], tangent [vx, vy, omega]) of the
mobile base, and SE(2) x R^n (gtsam Pose2Vector, stored [x, y, theta, q],
tangent [vx, vy, omega, qdot]) of the mobile manipulators, where every
chart operation acts on the two blocks separately. The SE(3) space comes
with a later slice. Chart operations take tensors with any leading
dimensions.
"""

from __future__ import annotations

import dataclasses

import torch

from . import se2

__all__ = ["StateSpace", "VectorSpace", "SE2Space", "SE2VectorSpace"]


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """Static descriptor of a configuration space.

    kind: 'vector' | 'se2' | 'se2_vector'; dim: tangent dimension (the
    robot's dof)."""

    kind: str
    dim: int

    def __post_init__(self):
        if self.kind not in ("vector", "se2", "se2_vector"):
            raise ValueError(f"unknown state space kind {self.kind!r}")

    @property
    def is_vector(self) -> bool:
        return self.kind == "vector"

    def _apply(self, se2_op, vec_op, *xs):
        """se2_op on SE(2) states, vec_op on vectors, both blockwise on
        SE(2) x R^n."""
        if self.kind == "vector":
            return vec_op(*xs)
        if self.kind == "se2":
            return se2_op(*xs)
        return torch.cat([se2_op(*(x[..., :3] for x in xs)),
                          vec_op(*(x[..., 3:] for x in xs))], dim=-1)

    def retract(self, x, delta):
        """Right retraction x * Exp(delta) (exact exp on each block)."""
        return self._apply(se2.retract, torch.add, x, delta)

    def local(self, x, y):
        """Log(x^-1 y): the tangent of y in the chart centred at x."""
        return self._apply(se2.local, lambda a, b: b - a, x, y)

    def compose(self, x, y):
        return self._apply(se2.compose, torch.add, x, y)

    def inverse(self, x):
        return self._apply(se2.inverse, torch.neg, x)

    def expmap(self, delta):
        return self._apply(se2.expmap, lambda v: v, delta)

    def logmap(self, x):
        return self._apply(se2.logmap, lambda v: v, x)

    def interpolate_linear(self, x, y, alpha):
        """Chart interpolation x * Exp(alpha * Log(x^-1 y)); a lerp on a
        vector space (initPose2TrajStraightLine, TrajUtils.cpp:76-93;
        initPose2VectorTrajStraightLine, TrajUtils.cpp:53-73)."""
        return self.retract(x, alpha * self.local(x, y))


def VectorSpace(d: int) -> StateSpace:
    return StateSpace("vector", d)


def SE2Space() -> StateSpace:
    return StateSpace("se2", 3)


def SE2VectorSpace(n: int) -> StateSpace:
    """SE(2) x R^n: a mobile base with n more joints."""
    return StateSpace("se2_vector", 3 + n)

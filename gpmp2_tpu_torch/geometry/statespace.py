"""Configuration-space descriptor (port of gpmp2_tpu/geometry/statespace.py).

Only the vector space R^d of the arm families is ported so far; the SE(2),
SE(2) x R^n and SE(3) spaces of the mobile families come with later slices.
"""

from __future__ import annotations

import dataclasses

__all__ = ["StateSpace", "VectorSpace"]


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """Static descriptor of a configuration space: kind and tangent dim."""

    kind: str
    dim: int

    @property
    def is_vector(self) -> bool:
        return self.kind == "vector"

    def retract(self, x, delta):
        """Right retraction x * Exp(delta); x + delta on a vector space."""
        return x + delta

    def local(self, x, y):
        """Log(x^-1 y): y - x on a vector space."""
        return y - x


def VectorSpace(d: int) -> StateSpace:
    return StateSpace("vector", d)

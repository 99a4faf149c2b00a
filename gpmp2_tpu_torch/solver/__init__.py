"""Batched Gauss-Newton / LM / Dogleg over block-tridiagonal normal
equations (port of gpmp2_tpu/solver; the solve is kernel K1,
ops/btsolve.py)."""

from .optimize import OptimizerParams, OptResult, optimize_batch

__all__ = ["OptimizerParams", "OptResult", "optimize_batch"]

"""Batched Gauss-Newton / LM / Dogleg over block-tridiagonal normal
equations (port of gpmp2_tpu/solver; the solve is kernel K1,
ops/btsolve.py, or for long horizons the Schur-partitioned solve,
solver/partitioned.py)."""

from .optimize import OptimizerParams, OptResult, optimize_batch
from .partitioned import block_tridiag_solve_partitioned, block_tridiag_solve_ts_sharded

__all__ = ["OptimizerParams", "OptResult", "optimize_batch",
           "block_tridiag_solve_partitioned", "block_tridiag_solve_ts_sharded"]

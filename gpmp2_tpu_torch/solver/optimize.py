"""Batched nonlinear least squares: Gauss-Newton and Levenberg-Marquardt.

Port of gpmp2_tpu/solver/optimize.py::optimize_batch with the per-lane
semantics of its `step` kept exactly:

  - LM: lambda_0 100, factor 10 (BatchTrajOptimizer.cpp:226, GTSAM
    defaults), damping H + lambda I, give-up when lambda exceeds 1e5;
  - GTSAM checkConvergence: converged when newErr <= errTol, or the
    absolute decrease <= absTol, or the relative decrease <= relTol;
  - a non-finite step is zeroed and the lane rejected; `gave_up` (the lane
    stopped without converging) is tracked apart from `converged`;
  - GN with `iter_no_increase` reverts a final increasing step.

Each attempt solves at the carried linearization, linearizes the
candidate once (which yields its error), and accepts or rejects per lane.
The loop is a plain Python loop over max_iter + reject_budget attempts
that stops as soon as no lane is active; steps on inactive lanes are
no-ops, so the result does not depend on when it stops. The JAX
package's chunked, compacted and tail schedules and its flat/lane layouts
worked around the TPU's dispatch and tiling and have no counterpart here;
Dogleg is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.btsolve import batched_block_tridiag_solve

__all__ = ["OptimizerParams", "OptResult", "optimize_batch"]


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    method: str = "lm"  # 'gaussnewton' | 'lm'
    max_iter: int = 50
    rel_thresh: float = 1e-2  # relativeErrorTol
    abs_thresh: float = 1e-5  # absoluteErrorTol (GTSAM default)
    err_thresh: float = 0.0  # errorTol (GTSAM default)
    iter_no_increase: bool = True
    # LM
    lambda_init: float = 100.0
    lambda_factor: float = 10.0
    lambda_max: float = 1e5
    lambda_min: float = 0.0
    reject_budget: int = 14  # extra attempts to absorb rejected LM steps
    # plan_batch re-solves the lanes that gave up in float64
    # (planner/batch.py:_rescue_gave_up_f64)
    rescue_f64: bool = False


class OptResult(NamedTuple):
    traj: object  # optimized trajectory (batched)
    error: torch.Tensor  # (B,) final graph error
    iterations: torch.Tensor  # (B,) accepted steps taken
    converged: torch.Tensor  # (B,) bool: GTSAM checkConvergence fired
    gave_up: torch.Tensor  # (B,) bool: stopped without converging


def _select(mask, new, old):
    """Per-lane select over batch-first tensors; mask: (B,)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _select_all(mask, new, old):
    return type(old)(*(_select(mask, a, b) for a, b in zip(new, old)))


def optimize_batch(linearize_fn: Callable, retract_fn: Callable, traj0,
                   params: OptimizerParams) -> OptResult:
    """Run the batched optimizer to per-problem convergence.

    linearize_fn(traj) -> (H_diag (B,n,m,m), H_off (B,n-1,m,m), b (B,n,m),
    err (B,)); retract_fn(traj, delta (B,n,m)) -> traj; traj0 is a
    NamedTuple of batch-first tensors."""
    method = params.method
    if method not in ("lm", "gaussnewton"):
        raise NotImplementedError(f"optimizer {method!r} is a later slice")
    lm = method == "lm"

    traj = traj0
    lin = linearize_fn(traj)
    err = lin[3]
    B = err.shape[0]
    tr = torch.full_like(err, params.lambda_init if lm else 0.0)
    zero_lam = torch.zeros_like(err)
    converged = err <= params.err_thresh
    gave_up = torch.zeros_like(converged)
    iters = torch.zeros((B,), dtype=torch.int32, device=err.device)
    prev_traj, prev_err = traj, err

    total = params.max_iter + (params.reject_budget if lm else 0)
    for _ in range(total):
        active = ~converged & ~gave_up & (iters < params.max_iter)
        if not bool(active.any()):
            break
        H_diag, H_off, b, _ = lin
        delta = batched_block_tridiag_solve(H_diag, H_off, b,
                                            lam=tr if lm else zero_lam)
        ok = torch.isfinite(delta).reshape(B, -1).all(dim=-1)
        delta = _select(ok, delta, torch.zeros_like(delta))
        cand = retract_fn(traj, delta)
        cand_lin = linearize_fn(cand)
        new_err = cand_lin[3]
        finite = ok & torch.isfinite(new_err)

        if lm:
            better = finite & (new_err < err)
            accept = active & better
            reject = active & ~better
            tr = torch.where(
                accept,
                torch.clamp(tr / params.lambda_factor, min=params.lambda_min),
                torch.where(reject, tr * params.lambda_factor, tr),
            )
            gave = reject & (tr > params.lambda_max)
        else:
            accept = active & finite
            gave = active & ~finite

        # GTSAM checkConvergence on (current, new) errors
        abs_dec = err - new_err
        rel_dec = abs_dec / torch.clamp(err, min=1e-30)
        conv_now = accept & ((new_err <= params.err_thresh)
                             | (abs_dec <= params.abs_thresh)
                             | (rel_dec <= params.rel_thresh))

        prev_traj = _select_all(accept, traj, prev_traj)
        prev_err = torch.where(accept, err, prev_err)
        traj = _select_all(accept, cand, traj)
        lin = tuple(_select(accept, c, o) for c, o in zip(cand_lin, lin))
        err = torch.where(accept, new_err, err)
        converged = converged | conv_now
        gave_up = gave_up | gave
        iters = iters + accept.to(torch.int32)

    if params.iter_no_increase and not lm:
        increased = err > prev_err
        traj = _select_all(increased, prev_traj, traj)
        err = torch.where(increased, prev_err, err)
    return OptResult(traj, err, iters, converged, gave_up)

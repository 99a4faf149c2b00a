"""Batched nonlinear least squares: Gauss-Newton, Levenberg-Marquardt, Dogleg.

Port of gpmp2_tpu/solver/optimize.py::optimize_batch with the per-lane
semantics of its `step` kept exactly:

  - LM: lambda_0 100, factor 10 (BatchTrajOptimizer.cpp:226, GTSAM
    defaults), damping H + lambda I, give-up when lambda exceeds 1e5;
  - Dogleg: Delta_0 0.2 (BatchTrajOptimizer.cpp:222); the Gauss-Newton
    point (kernel K1 with lambda = 0), the Cauchy point, and the blend on
    the trust radius; gain ratio rho = actual / predicted decrease, the
    radius grows to max(Delta, 3 |delta|) when rho > 0.75 and halves when
    rho < 0.25 (GTSAM DoglegOptimizerImpl), give-up when it falls below
    delta_min. One attempt per step, as in the JAX package;
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
worked around the TPU's dispatch and tiling and have no counterpart here,
so Dogleg runs on the one layout the port has.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.btsolve import batched_block_tridiag_solve

__all__ = ["OptimizerParams", "OptResult", "optimize_batch", "dogleg_delta",
           "model_decrease"]


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    method: str = "lm"  # 'gaussnewton' | 'lm' | 'dogleg'
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
    # Dogleg
    delta_init: float = 0.2
    delta_min: float = 1e-5
    reject_budget: int = 14  # extra attempts to absorb rejected LM / Dogleg steps
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


def _apply_H(H_diag, H_off, v):
    """H v for the block-tridiagonal H and v (B, n, m)."""
    Hv = (H_diag @ v[..., None])[..., 0]
    Hv[:, :-1] += (H_off @ v[:, 1:, :, None])[..., 0]
    Hv[:, 1:] += (H_off.mT @ v[:, :-1, :, None])[..., 0]
    return Hv


def _dot(a, b):
    """Per-lane inner product of (B, n, m) tensors."""
    return (a * b).sum(dim=(-2, -1))


def model_decrease(H_diag, H_off, b, delta):
    """Predicted error decrease b^T delta - 0.5 delta^T H delta per lane."""
    return _dot(b, delta) - 0.5 * _dot(delta, _apply_H(H_diag, H_off, delta))


def dogleg_delta(H_diag, H_off, b, radius):
    """Classic dogleg step for trust radii (B,): the Gauss-Newton point
    (K1 with lambda = 0) when it lies inside the radius, the clipped
    Cauchy point when that lies outside, else the point on the segment
    between them at the radius (gpmp2_tpu/solver/optimize.py:298-320)."""
    B = b.shape[0]
    d_gn = batched_block_tridiag_solve(H_diag, H_off, b, lam=torch.zeros_like(radius))
    g = b  # the negative gradient
    alpha = _dot(g, g) / torch.clamp(_dot(g, _apply_H(H_diag, H_off, g)), min=1e-30)
    d_sd = alpha[:, None, None] * g
    n_gn, n_sd = _dot(d_gn, d_gn).sqrt(), _dot(d_sd, d_sd).sqrt()
    d_sd_clip = d_sd * (radius / torch.clamp(n_sd, min=1e-30))[:, None, None]
    diff = d_gn - d_sd
    qa = _dot(diff, diff)
    qb = 2.0 * _dot(d_sd, diff)
    qc = n_sd**2 - radius**2
    disc = torch.clamp(qb * qb - 4 * qa * qc, min=0.0)
    t = (-qb + disc.sqrt()) / torch.clamp(2 * qa, min=1e-30)
    d_mix = d_sd + t[:, None, None] * diff
    pick = lambda mask, a, c: torch.where(mask.reshape(B, 1, 1), a, c)  # noqa: E731
    return pick(n_gn <= radius, d_gn, pick(n_sd >= radius, d_sd_clip, d_mix))


def optimize_batch(linearize_fn: Callable, retract_fn: Callable, traj0,
                   params: OptimizerParams) -> OptResult:
    """Run the batched optimizer to per-problem convergence.

    linearize_fn(traj) -> (H_diag (B,n,m,m), H_off (B,n-1,m,m), b (B,n,m),
    err (B,)); retract_fn(traj, delta (B,n,m)) -> traj; traj0 is a
    NamedTuple of batch-first tensors. `tr` below is LM's lambda or
    Dogleg's trust radius per lane."""
    method = params.method
    if method not in ("lm", "gaussnewton", "dogleg"):
        raise ValueError(f"unknown optimizer {method!r}")

    traj = traj0
    lin = linearize_fn(traj)
    err = lin[3]
    B = err.shape[0]
    tr = torch.full_like(err, {"lm": params.lambda_init, "dogleg": params.delta_init,
                               "gaussnewton": 0.0}[method])
    converged = err <= params.err_thresh
    gave_up = torch.zeros_like(converged)
    iters = torch.zeros((B,), dtype=torch.int32, device=err.device)
    prev_traj, prev_err = traj, err

    total = params.max_iter + (0 if method == "gaussnewton" else params.reject_budget)
    for _ in range(total):
        active = ~converged & ~gave_up & (iters < params.max_iter)
        if not bool(active.any()):
            break
        H_diag, H_off, b, _ = lin
        if method == "dogleg":
            delta = dogleg_delta(H_diag, H_off, b, tr)
        else:  # LM damps by lambda; GN's tr stays 0
            delta = batched_block_tridiag_solve(H_diag, H_off, b, lam=tr)
        ok = torch.isfinite(delta).reshape(B, -1).all(dim=-1)
        delta = _select(ok, delta, torch.zeros_like(delta))
        cand = retract_fn(traj, delta)
        cand_lin = linearize_fn(cand)
        new_err = cand_lin[3]
        finite = ok & torch.isfinite(new_err)

        if method == "lm":
            better = finite & (new_err < err)
            accept = active & better
            reject = active & ~better
            tr = torch.where(
                accept,
                torch.clamp(tr / params.lambda_factor, min=params.lambda_min),
                torch.where(reject, tr * params.lambda_factor, tr),
            )
            gave = reject & (tr > params.lambda_max)
        elif method == "dogleg":
            pred = model_decrease(H_diag, H_off, b, delta)
            rho = (err - new_err) / torch.clamp(pred, min=1e-30)
            better = finite & (new_err < err) & (pred > 0)
            accept = active & better
            reject = active & ~better
            grow = accept & (rho > 0.75)
            shrink = active & (rho < 0.25)
            tr = torch.where(grow, torch.maximum(tr, 3.0 * _dot(delta, delta).sqrt()),
                             torch.where(shrink, 0.5 * tr, tr))
            gave = reject & (tr < params.delta_min)
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

    if params.iter_no_increase and method == "gaussnewton":
        increased = err > prev_err
        traj = _select_all(increased, prev_traj, traj)
        err = torch.where(increased, prev_err, err)
    return OptResult(traj, err, iters, converged, gave_up)

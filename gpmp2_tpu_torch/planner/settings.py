"""Trajectory optimizer settings (numpy only; the fields of
gpmp2_tpu/planner/settings.py that the port reads).

Port of gpmp2/planner/TrajOptimizerSetting.{h,cpp}
with identical defaults (TrajOptimizerSetting.cpp:15-56):

  total_step 10, total_time 1.0, epsilon 0.2, cost_sigma 0.1,
  obs_check_inter 5, Dogleg optimizer, max_iter 50, rel_thresh 1e-2,
  conf/vel prior sigma 1e-4, Qc = identity, limits off,
  final_iter_no_increase true.

Joint limits and the verbosity trace are later slices: their value fields
are absent, and `make_problem` raises when `flag_pos_limit` or
`flag_vel_limit` is set.

Noise models are expressed directly as sigmas (the reference wraps them in
gtsam noise models; the solver consumes precisions 1/sigma^2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["TrajOptimizerSetting"]


@dataclasses.dataclass
class TrajOptimizerSetting:
    """Mirror of gpmp2::TrajOptimizerSetting (TrajOptimizerSetting.h:17-100)."""

    dof: int
    # trajectory shape
    total_step: int = 10
    total_time: float = 1.0
    # start/goal priors
    conf_prior_sigma: float = 1e-4
    vel_prior_sigma: float = 1e-4
    # joint limits
    flag_pos_limit: bool = False
    flag_vel_limit: bool = False
    # obstacle factors
    epsilon: float = 0.2
    cost_sigma: float = 0.1
    obs_check_inter: int = 5
    # GP
    Qc: Optional[np.ndarray] = None  # (dof, dof) covariance, default identity
    # optimization
    opt_type: str = "dogleg"  # 'gaussnewton' | 'lm' | 'dogleg'
    final_iter_no_increase: bool = True
    rel_thresh: float = 1e-2
    max_iter: int = 50

    def __post_init__(self):
        d = self.dof
        if self.Qc is None:
            self.Qc = np.eye(d)
        else:
            self.Qc = np.asarray(self.Qc, dtype=np.float64)
            if self.Qc.ndim == 0:
                self.Qc = float(self.Qc) * np.eye(d)
        assert self.opt_type in ("gaussnewton", "lm", "dogleg")

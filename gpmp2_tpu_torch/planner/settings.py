"""Trajectory optimizer settings (numpy only; the fields of
gpmp2_tpu/planner/settings.py that the port reads).

Port of gpmp2/planner/TrajOptimizerSetting.{h,cpp}
with identical defaults (TrajOptimizerSetting.cpp:15-56):

  total_step 10, total_time 1.0, epsilon 0.2, cost_sigma 0.1,
  obs_check_inter 5, Dogleg optimizer, max_iter 50, rel_thresh 1e-2,
  conf/vel prior sigma 1e-4, Qc = identity, limits off (position limits
  -/+1e6, velocity limit 1e6), pos/vel limit sigma 1e-3, limit thresh
  1e-3, final_iter_no_increase true, verbosity none.

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
    joint_pos_limits_up: Optional[np.ndarray] = None  # default +1e6
    joint_pos_limits_down: Optional[np.ndarray] = None  # default -1e6
    vel_limits: Optional[np.ndarray] = None  # default 1e6
    pos_limit_thresh: Optional[np.ndarray] = None  # default 1e-3
    vel_limit_thresh: Optional[np.ndarray] = None  # default 1e-3
    pos_limit_sigma: Optional[np.ndarray] = None  # default 1e-3 (isotropic)
    vel_limit_sigma: Optional[np.ndarray] = None  # default 1e-3
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
    # per-attempt trace (reference verbosity enum None/Error,
    # TrajOptimizerSetting.h:21; printouts BatchTrajOptimizer.cpp:235-282)
    verbosity: str = "none"  # 'none' | 'error'

    def __post_init__(self):
        d = self.dof

        def vec(v, default):
            if v is None:
                return np.full((d,), default, dtype=np.float64)
            v = np.asarray(v, dtype=np.float64)
            if v.ndim == 0:
                return np.full((d,), float(v), dtype=np.float64)
            if v.shape != (d,):
                raise ValueError(f"TrajOptimizerSetting: expected ({d},), got {v.shape}")
            return v

        self.joint_pos_limits_up = vec(self.joint_pos_limits_up, 1e6)
        self.joint_pos_limits_down = vec(self.joint_pos_limits_down, -1e6)
        self.vel_limits = vec(self.vel_limits, 1e6)
        self.pos_limit_thresh = vec(self.pos_limit_thresh, 1e-3)
        self.vel_limit_thresh = vec(self.vel_limit_thresh, 1e-3)
        self.pos_limit_sigma = vec(self.pos_limit_sigma, 1e-3)
        self.vel_limit_sigma = vec(self.vel_limit_sigma, 1e-3)
        if self.Qc is None:
            self.Qc = np.eye(d)
        else:
            self.Qc = np.asarray(self.Qc, dtype=np.float64)
            if self.Qc.ndim == 0:
                self.Qc = float(self.Qc) * np.eye(d)
        assert self.opt_type in ("gaussnewton", "lm", "dogleg")
        assert self.verbosity in ("none", "error")

    def set_verbosity_error(self):
        """Per-attempt error trace (ref setVerbosityError,
        TrajOptimizerSetting.h:77)."""
        self.verbosity = "error"

    def set_verbosity_none(self):
        self.verbosity = "none"

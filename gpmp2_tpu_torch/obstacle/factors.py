"""Obstacle and self-collision hinge residuals (port of gpmp2_tpu/obstacle/factors.py).

hinge: err = eps_total - d(x) when d(x) <= eps_total (equality included,
ObstacleCost.h:41-49), else 0; an out-of-range SDF query gives cost 0.
Per body sphere, eps_total = sphere_radius + eps (ObstacleSDFFactor-inl.h).
Self-collision (SelfCollision.h:66-132): per sphere pair (a, b),
eps_total = r_a + r_b + eps_pair and the hinge runs on the centre distance.
"""

from __future__ import annotations

import torch

from ..kinematics.robot import RobotModel, sphere_centers_world
from .sdf import PlanarSDF, SignedDistanceField, sdf_lookup_points

__all__ = ["hinge_loss", "obstacle_factor_error", "obstacle_planar_factor_error",
           "self_collision_terms", "self_collision_error"]


def hinge_loss(dist, eps_total, in_range):
    """max(0, eps - d) with out-of-range clamped to zero cost."""
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    err = torch.where(dist <= eps_total, eps_total - dist, zero)
    return torch.where(in_range, err, zero)


def obstacle_factor_error(model: RobotModel, sdf: SignedDistanceField, q, eps):
    """3D obstacle factor residual: q (..., d) -> (..., S)
    (ObstacleSDFFactor::evaluateError, ObstacleSDFFactor-inl.h:17-60); a
    screen on the field takes eps_total as its threshold
    (gpmp2_tpu/obstacle/factors.py:47-55)."""
    centers = sphere_centers_world(model, q)
    eps_total = model.sphere_radii + eps
    dist, *_, ok = sdf_lookup_points(sdf, centers, eps_total)
    return hinge_loss(dist, eps_total, ok)


def obstacle_planar_factor_error(model: RobotModel, sdf: PlanarSDF, q, eps):
    """2D obstacle factor residual, spheres projected to the plane: q (..., d)
    -> (..., S) (ObstaclePlanarSDFFactor::evaluateError,
    ObstaclePlanarSDFFactor-inl.h:17-57)."""
    centers = sphere_centers_world(model, q)
    dist, *_, ok = sdf_lookup_points(sdf, centers)  # reads x and y
    return hinge_loss(dist, model.sphere_radii + eps, ok)


def self_collision_terms(centers, radii, pairs_a, pairs_b, pair_eps):
    """Self-collision hinge of sphere centres (..., S, 3) over the pairs
    (P,): residual (..., P), the unit vector (..., P, 3) from b's centre to
    a's, and the active mask (..., P). The distance is
    sqrt(max(d^2, 1e-12)), so coincident centres keep a finite direction."""
    diff = centers[..., pairs_a, :] - centers[..., pairs_b, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    eps_total = radii[pairs_a] + radii[pairs_b] + pair_eps
    active = dist <= eps_total
    r = torch.where(active, eps_total - dist, torch.zeros_like(dist))
    return r, diff / dist[..., None], active


def self_collision_error(model: RobotModel, q, pairs_a, pairs_b, pair_eps):
    """Self-collision residual over sphere pairs: q (..., d) -> (..., P)
    (SelfCollision.h:112-132); per-pair sigmas are the caller's weights."""
    return self_collision_terms(sphere_centers_world(model, q), model.sphere_radii,
                                pairs_a, pairs_b, pair_eps)[0]

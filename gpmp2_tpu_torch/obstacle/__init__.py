"""SDF environments and obstacle factors (port of gpmp2_tpu/obstacle)."""

from .factors import (hinge_loss, obstacle_factor_error, obstacle_planar_factor_error,
                      self_collision_error)
from .sdf import (PlanarSDF, SignedDistanceField, pack_planar_sdf, pack_sdf, planar_sdf_lookup,
                  screen_sdf, sdf_lookup)

__all__ = ["PlanarSDF", "SignedDistanceField", "planar_sdf_lookup", "sdf_lookup", "pack_sdf",
           "pack_planar_sdf", "screen_sdf", "hinge_loss", "obstacle_factor_error",
           "obstacle_planar_factor_error", "self_collision_error"]

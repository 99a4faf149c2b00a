from .generate2d import Dataset2D, add_obstacle_2d, generate_2d_dataset
from .generate3d import Dataset3D, add_obstacle_3d, generate_3d_dataset
from .sdf_gen import (planar_sdf_from_occupancy, sdf_from_occupancy,
                      signed_distance_field_2d, signed_distance_field_3d)

__all__ = ["Dataset2D", "add_obstacle_2d", "generate_2d_dataset", "Dataset3D",
           "add_obstacle_3d", "generate_3d_dataset", "planar_sdf_from_occupancy",
           "sdf_from_occupancy", "signed_distance_field_2d",
           "signed_distance_field_3d"]

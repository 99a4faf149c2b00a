from .generate3d import Dataset3D, add_obstacle_3d, generate_3d_dataset
from .sdf_gen import sdf_from_occupancy, signed_distance_field_3d

__all__ = ["Dataset3D", "add_obstacle_3d", "generate_3d_dataset",
           "sdf_from_occupancy", "signed_distance_field_3d"]

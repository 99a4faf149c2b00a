"""Occupancy grid -> signed distance field (port of gpmp2_tpu/datasets/sdf_gen.py).

field = EDT(~occupied) - EDT(occupied), in cells, times cell_size; an
all-free map gives +1000 everywhere. The exact EDT runs in the native C++
component on the host; the field then moves to the requested device
(default: CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..obstacle.sdf import PlanarSDF, SignedDistanceField

__all__ = ["signed_distance_field_2d", "signed_distance_field_3d",
           "planar_sdf_from_occupancy", "sdf_from_occupancy", "dataset_screen_boxes"]


def _signed_distance_field(ground_truth_map, cell_size) -> np.ndarray:
    occ = np.asarray(ground_truth_map) > 0.75
    if not occ.any():
        return np.full(occ.shape, 1000.0)
    field = native.edt(occ) - native.edt(~occ)
    return field * float(cell_size)


def signed_distance_field_2d(ground_truth_map, cell_size) -> np.ndarray:
    """Occupancy (rows=Y, cols=X; 1 = obstacle) -> SDF in meters, same layout."""
    return _signed_distance_field(ground_truth_map, cell_size)


def signed_distance_field_3d(ground_truth_map, cell_size) -> np.ndarray:
    """Occupancy volume -> SDF in meters, same layout as the input."""
    return _signed_distance_field(ground_truth_map, cell_size)


def _tensors(origin, cell_size, field, dtype, device):
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,  # noqa: E731
                                  device=device)
    return f(origin), f(float(cell_size)), f(np.ascontiguousarray(field))


def planar_sdf_from_occupancy(origin, cell_size, occupancy, dtype=torch.float32,
                              device=None) -> PlanarSDF:
    """Occupancy (rows=Y, cols=X) -> PlanarSDF on `device`."""
    field = signed_distance_field_2d(occupancy, cell_size)
    return PlanarSDF(*_tensors(origin, cell_size, field, dtype, device))


def sdf_from_occupancy(origin, cell_size, occupancy_xyz, dtype=torch.float32,
                       device=None, screen_boxes=None) -> SignedDistanceField:
    """3D occupancy in the reference dataset layout (X, Y, Z)
    (generate3Ddataset.m:10-12) -> SignedDistanceField with (Z, Y, X) data
    on `device` (WAMPlannerExample.m:23-26 performs the same transpose).
    `screen_boxes` (K, 2, 3), the obstacle boxes' voxel-centre hulls
    (`dataset_screen_boxes`), enables the hull screen of the lookup."""
    field = signed_distance_field_3d(occupancy_xyz, cell_size)
    origin, cell, data = _tensors(origin, cell_size, np.transpose(field, (2, 1, 0)),
                                  dtype, device)
    boxes = (None if screen_boxes is None else
             torch.as_tensor(np.asarray(screen_boxes, np.float64), dtype=dtype,
                             device=data.device))
    return SignedDistanceField(origin, cell, data, screen_boxes=boxes)


def dataset_screen_boxes(ds, dtype=np.float64) -> np.ndarray:
    """(K, 2, 3) world [lo; hi] voxel-centre hulls of a Dataset3D's boxes,
    from its `corner_idx` rows ([x_lo, x_hi, y_lo, y_hi, z_lo, z_hi] cell
    indices, generate3d.py:add_obstacle_3d): world = origin + idx *
    cell_size (gpmp2_tpu/datasets/sdf_gen.py:90-99)."""
    ci = np.asarray(ds.corner_idx, dtype)
    origin = np.asarray(ds.origin, dtype)
    lo = origin[None, :] + ci[:, [0, 2, 4]] * ds.cell_size
    hi = origin[None, :] + ci[:, [1, 3, 5]] * ds.cell_size
    return np.ascontiguousarray(np.stack([lo, hi], axis=1))

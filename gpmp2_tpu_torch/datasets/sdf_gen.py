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
           "planar_sdf_from_occupancy", "sdf_from_occupancy"]


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
                       device=None) -> SignedDistanceField:
    """3D occupancy in the reference dataset layout (X, Y, Z)
    (generate3Ddataset.m:10-12) -> SignedDistanceField with (Z, Y, X) data
    on `device` (WAMPlannerExample.m:23-26 performs the same transpose)."""
    field = signed_distance_field_3d(occupancy_xyz, cell_size)
    return SignedDistanceField(*_tensors(origin, cell_size,
                                         np.transpose(field, (2, 1, 0)), dtype, device))

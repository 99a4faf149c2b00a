"""Occupancy grid -> signed distance field (port of gpmp2_tpu/datasets/sdf_gen.py).

field = EDT(~occupied) - EDT(occupied), in cells, times cell_size; an
all-free map gives +1000 everywhere. The exact EDT runs in the native C++
component on the host; the field then moves to the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..obstacle.sdf import SignedDistanceField

__all__ = ["signed_distance_field_3d", "sdf_from_occupancy"]


def signed_distance_field_3d(ground_truth_map, cell_size) -> np.ndarray:
    """Occupancy volume -> SDF in meters, same layout as the input."""
    occ = np.asarray(ground_truth_map) > 0.75
    if not occ.any():
        return np.full(occ.shape, 1000.0)
    field = native.edt(occ) - native.edt(~occ)
    return field * float(cell_size)


def sdf_from_occupancy(origin, cell_size, occupancy_xyz, dtype=torch.float32,
                       device=None) -> SignedDistanceField:
    """3D occupancy in the reference dataset layout (X, Y, Z)
    (generate3Ddataset.m:10-12) -> SignedDistanceField with (Z, Y, X) data
    on `device` (WAMPlannerExample.m:23-26 performs the same transpose)."""
    field = signed_distance_field_3d(occupancy_xyz, cell_size)
    data_zyx = np.ascontiguousarray(np.transpose(field, (2, 1, 0)))
    return SignedDistanceField(
        origin=torch.as_tensor(np.asarray(origin, np.float64), dtype=dtype,
                               device=device),
        cell_size=torch.as_tensor(float(cell_size), dtype=dtype, device=device),
        data=torch.as_tensor(data_zyx, dtype=dtype, device=device),
    )

"""3D occupancy dataset presets (numpy only; a copy of
gpmp2_tpu/datasets/generate3d.py).

Port of matlab/+gpmp2/generate3Ddataset.m /
gpmp2_python/datasets/generate3Ddataset.py: SmallDemo, WAMDeskDataset.
Map layout follows the reference: (rows=X, cols=Y, z=Z)
(generate3Ddataset.m:10-12); `sdf_from_occupancy` converts to the SDF's
(Z, Y, X) layout.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Dataset3D", "generate_3d_dataset", "add_obstacle_3d"]


@dataclasses.dataclass
class Dataset3D:
    map: np.ndarray  # (X, Y, Z) occupancy
    rows: int
    cols: int
    z: int
    origin_x: float
    origin_y: float
    origin_z: float
    cell_size: float
    corner_idx: np.ndarray  # (n_boxes, 6) cell extents for plotting

    @property
    def origin(self):
        return np.array([self.origin_x, self.origin_y, self.origin_z])


def add_obstacle_3d(position, size, occ, corner=None):
    """Stamp a box of 1s (generate3Ddataset.py:22-51 semantics)."""
    hr = int(math.floor((size[0] - 1) / 2))
    hc = int(math.floor((size[1] - 1) / 2))
    hz = int(math.floor((size[2] - 1) / 2))
    occ[
        position[0] - hr - 1 : position[0] + hr,
        position[1] - hc - 1 : position[1] + hc,
        position[2] - hz - 1 : position[2] + hz,
    ] = 1.0
    row = np.asarray(
        [
            position[0] - hr - 1, position[0] + hr - 1,
            position[1] - hc - 1, position[1] + hc - 1,
            position[2] - hz - 1, position[2] + hz - 1,
        ]
    ).reshape(1, 6)
    corner = row if corner is None else np.concatenate([corner, row], axis=0)
    return occ, corner


def generate_3d_dataset(name: str) -> Dataset3D:
    if name == "SmallDemo":
        occ = np.zeros((200, 200, 200))
        occ, corner = add_obstacle_3d([150, 150, 150], [20, 20, 20], occ)
        return Dataset3D(occ, 200, 200, 200, -1.0, -1.0, -1.0, 0.01, corner)

    if name == "WAMDeskDataset":
        occ = np.zeros((300, 300, 300))
        corner = None
        boxes = [
            ([170, 220, 130], [140, 60, 5]),
            ([105, 195, 90], [10, 10, 80]),
            ([235, 195, 90], [10, 10, 80]),
            ([105, 245, 90], [10, 10, 80]),
            ([235, 245, 90], [10, 10, 80]),
            ([250, 190, 145], [60, 5, 190]),
            ([250, 90, 145], [60, 5, 190]),
            ([200, 190, 145], [40, 5, 190]),
            ([250, 140, 240], [60, 100, 5]),
            ([250, 140, 190], [60, 100, 5]),
            ([250, 140, 140], [60, 100, 5]),
            ([250, 140, 90], [60, 100, 5]),
        ]
        for pos, size in boxes:
            occ, corner = add_obstacle_3d(pos, size, occ, corner)
        return Dataset3D(occ, 300, 300, 300, -1.5, -1.5, -1.5, 0.01, corner)

    raise NameError(f"No such dataset '{name}'")

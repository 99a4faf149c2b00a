"""2D occupancy dataset presets.

Port of gpmp2_tpu/datasets/generate2d.py (matlab/+gpmp2/generate2Ddataset.m:18-84,
gpmp2_python/datasets/generate2Ddataset.py), numpy only: OneObstacleDataset, Empty,
TwoObstaclesDataset, MultiObstacleDataset, MobileMap1. Maps are
(rows=Y, cols=X) occupancy grids, obstacle placement semantics identical
(add_obstacle centers/sizes in cells).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Dataset2D", "generate_2d_dataset", "add_obstacle_2d"]


@dataclasses.dataclass
class Dataset2D:
    map: np.ndarray  # (rows, cols) occupancy, 1 = obstacle
    rows: int
    cols: int
    origin_x: float
    origin_y: float
    cell_size: float

    @property
    def origin(self):
        return np.array([self.origin_x, self.origin_y])


def add_obstacle_2d(position, size, occ: np.ndarray) -> np.ndarray:
    """Stamp a rectangle of 1s; position/size in cells (row, col), matching
    generate2Ddataset.py add_obstacle (floor((s-1)/2) half-sizes)."""
    hr = int(math.floor((size[0] - 1) / 2))
    hc = int(math.floor((size[1] - 1) / 2))
    occ[
        position[0] - hr - 1 : position[0] + hr,
        position[1] - hc - 1 : position[1] + hc,
    ] = 1.0
    return occ


def _get_center(x, y, ds: Dataset2D):
    return (
        np.asarray([y - ds.origin_y, x - ds.origin_x]) / ds.cell_size
    ).astype(int)


def _get_dim(w, h, ds: Dataset2D):
    return (np.asarray([h, w]) / ds.cell_size).astype(int)


def generate_2d_dataset(name: str) -> Dataset2D:
    if name in ("OneObstacleDataset", "Empty"):
        ds = Dataset2D(np.zeros((300, 300)), 300, 300, -1.0, -1.0, 0.01)
        if name == "OneObstacleDataset":
            add_obstacle_2d([190, 160], [60, 80], ds.map)
        return ds

    if name == "TwoObstaclesDataset":
        ds = Dataset2D(np.zeros((300, 300)), 300, 300, -1.0, -1.0, 0.01)
        add_obstacle_2d([200, 200], [80, 100], ds.map)
        add_obstacle_2d([160, 80], [30, 80], ds.map)
        return ds

    if name == "MultiObstacleDataset":
        ds = Dataset2D(np.zeros((300, 400)), 300, 400, -20.0, -10.0, 0.1)
        add_obstacle_2d(_get_center(12, 10, ds), _get_dim(5, 7, ds), ds.map)
        add_obstacle_2d(_get_center(-7, 10, ds), _get_dim(10, 7, ds), ds.map)
        add_obstacle_2d(_get_center(0, -5, ds), _get_dim(10, 5, ds), ds.map)
        return ds

    if name == "MobileMap1":
        ds = Dataset2D(np.zeros((500, 500)), 500, 500, -10.0, -10.0, 0.01)
        add_obstacle_2d(_get_center(0, 0, ds), _get_dim(1, 5, ds), ds.map)
        # walls
        add_obstacle_2d(_get_center(0, 4.5, ds), _get_dim(10, 1, ds), ds.map)
        add_obstacle_2d(_get_center(0, -4.5, ds), _get_dim(10, 1, ds), ds.map)
        add_obstacle_2d(_get_center(4.5, 0, ds), _get_dim(1, 10, ds), ds.map)
        add_obstacle_2d(_get_center(-4.5, 0, ds), _get_dim(1, 10, ds), ds.map)
        return ds

    raise NameError(f"No such dataset '{name}'")

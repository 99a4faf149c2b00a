"""Occupancy grids from the upstream presets' box lists.

The boxes sit in each configuration file; these functions stamp them as
gpmp2's generate2Ddataset.m and generate3Ddataset.m do: a box of `size`
cells centred on `position` covers [position - h - 1, position + h) on
each axis (0-based), h = floor((size - 1) / 2). As MATLAB's indexed
assignment does, a box that reaches past the grid grows it with free
cells, keeping the origin and the cell size; signedDistanceField2D/3D
then take the grown map whole.
"""

import math

import numpy as np


def _stamp(occ, position, size):
    lo, hi = [], []
    for p, s in zip(position, size):
        h = int(math.floor((s - 1) / 2))
        lo.append(int(p) - h - 1)
        hi.append(int(p) + h)
    if min(lo) < 0:
        raise ValueError(f"a box at {list(position)} reaches below index 0")
    grow = [max(0, b - n) for b, n in zip(hi, occ.shape)]
    if any(grow):
        occ = np.pad(occ, [(0, g) for g in grow])
    occ[tuple(slice(a, b) for a, b in zip(lo, hi))] = 1.0
    return occ


def occupancy(field):
    """The occupancy grid (float64, 1 = occupied) of a configuration's
    `field`: 3D grids are (X, Y, Z) and take boxes in cells
    (`boxes_cells`: [[position], [size]]); 2D grids are (rows = Y,
    cols = X) and take boxes in metres (`boxes_m`: [x, y, width, height],
    converted to cells by truncation, as generate2Ddataset.m's
    get_center and get_dim do). The grid starts at `shape` and grows to
    cover every box."""
    occ = np.zeros(field["shape"], dtype=np.float64)
    for position, size in field.get("boxes_cells", []):
        occ = _stamp(occ, position, size)
    ox, oy = field["origin"][0], field["origin"][1]
    cell = field["cell_size"]
    for x, y, w, h in field.get("boxes_m", []):
        center = (np.asarray([y - oy, x - ox]) / cell).astype(int)
        dims = (np.asarray([h, w]) / cell).astype(int)
        occ = _stamp(occ, center, dims)
    return occ

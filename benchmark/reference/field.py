"""Signed distance field and its multilinear lookup, in float64.

The field is (distance to the nearest occupied voxel) - (distance to the
nearest free voxel), in cells times the cell size; a grid with no
occupied voxel reads 1000 everywhere (gpmp2's signedDistanceField2D/3D).
Distances come from an exact squared Euclidean distance transform done
axis by axis as a brute-force min-plus product, D'(i) = min_j D(j) +
(i - j)^2, which is exact in float32 for squared distances below 2^24.
"""

import torch

_INF = 1e9
_CHUNK_BYTES = 256 << 20


def _min_plus_axis(D, axis):
    n = D.shape[axis]
    x = D.movedim(axis, -1)
    flat = x.reshape(-1, n)
    i = torch.arange(n, device=D.device, dtype=D.dtype)
    sq = (i[:, None] - i[None, :]) ** 2  # (i, j)
    rows = max(1, _CHUNK_BYTES // (4 * n * n))
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], rows):
        out[s:s + rows] = (flat[s:s + rows, None, :] + sq[None]).amin(-1)
    return out.reshape(x.shape).movedim(-1, axis)


def squared_edt(feature):
    """Squared distance (in cells) from every voxel to the nearest True
    voxel of `feature` (bool tensor), float32."""
    D = torch.where(feature, 0.0, _INF).to(torch.float32)
    for axis in range(feature.dim()):
        D = _min_plus_axis(D, axis)
    return D


def signed_distance(occupancy, cell_size):
    """The signed distance field (float64, metres) of a bool occupancy
    tensor, on the tensor's device."""
    occ = occupancy.bool()
    if not bool(occ.any()):
        return torch.full(occ.shape, 1000.0, dtype=torch.float64, device=occ.device)
    out = squared_edt(occ).double().sqrt()
    inside = squared_edt(~occ).double().sqrt()
    return (out - inside) * cell_size


class Field:
    """A signed distance field with its world frame. `data` is indexed
    [x, y, z] for a 3D grid (the occupancy's (X, Y, Z) layout) and
    [y, x] for a 2D grid (rows = Y)."""

    def __init__(self, data, origin, cell_size):
        self.data = data
        self.dim = data.dim()
        self.origin = torch.as_tensor(origin, dtype=torch.float64)
        self.cell_size = float(cell_size)
        # sizes along x, y (, z)
        self.sizes = (list(data.shape) if self.dim == 3 else [data.shape[1], data.shape[0]])

    def lookup(self, points):
        """(distance, in_range) at world points (..., >= dim), the
        multilinear interpolation of the grid values at the corners of
        the cell that holds each point. A point outside the grid reads
        the clamped value and in_range False."""
        origin = self.origin.to(dtype=points.dtype, device=points.device)
        c = (points[..., :self.dim] - origin) / self.cell_size
        ok = torch.ones(c.shape[:-1], dtype=torch.bool, device=c.device)
        idx, frac = [], []
        for k, size in enumerate(self.sizes):
            ck = c[..., k]
            ok = ok & (ck >= 0) & (ck <= size - 1)
            ck = ck.clamp(0.0, size - 1.0)
            i = ck.floor().long().clamp(0, size - 2)
            idx.append(i)
            frac.append(ck - i.to(ck.dtype))
        value = 0.0
        for corner in range(2 ** self.dim):
            w, at = 1.0, []
            for k in range(self.dim):
                bit = (corner >> k) & 1
                w = w * (frac[k] if bit else 1.0 - frac[k])
                at.append(idx[k] + bit)
            data = self.data.to(points.dtype)
            v = data[at[0], at[1], at[2]] if self.dim == 3 else data[at[1], at[0]]
            value = value + w * v
        return value, ok

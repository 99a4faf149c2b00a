"""3D signed distance field with a trilinear, differentiable lookup.

Port of gpmp2_tpu/obstacle/sdf.py (SignedDistanceField.h semantics):

  - data layout (Z, Y, X); world -> cell: col = (x - ox)/cell, likewise
    row from y and slice from z;
  - trilinear interpolation over the low cell corner, which is clamped to
    size-2 so every corner index is in bounds (at the exact top boundary
    the fraction becomes 1 and the last interior cell is used);
  - gradient of the interpolant in world units, (x, y, z) order;
  - an out-of-range query returns `ok = False`; the hinge turns it into
    cost 0 and gradient 0 (ObstacleCost.h:31-38).

Cell indices are clamped after the float -> int cast: a NaN coordinate
casts to an arbitrary integer, and an out-of-bounds index into a CUDA
tensor is a device-side fault, where JAX's clipped take never faults.
The corner-packed table and the gather screens of the JAX package are not
ported.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SignedDistanceField", "sdf_lookup", "sdf_lookup_components"]


@dataclasses.dataclass(frozen=True)
class SignedDistanceField:
    """3D signed distance field. data is (Z, Y, X), meters."""

    origin: torch.Tensor  # (3,) world coords of cell (0, 0, 0)
    cell_size: torch.Tensor  # ()
    data: torch.Tensor  # (Z, Y, X)

    def to(self, dtype=None, device=None) -> "SignedDistanceField":
        return SignedDistanceField(*(t.to(dtype=dtype, device=device)
                                     for t in dataclasses.astuple(self)))


def _corner_offsets_3d(rows, cols):
    # order matches the unpack below: d000 d010 d001 d011 d100 ...
    rc = rows * cols
    return [0, cols, 1, cols + 1, rc, rc + cols, rc + 1, rc + cols + 1]


def _low_corner(coord, size):
    """Clamped coordinate and its low cell index in [0, size - 2]."""
    c = torch.clamp(coord, 0.0, size - 1.0)
    idx = torch.floor(c).to(torch.int64).clamp(0, size - 2)
    return c, idx


def sdf_lookup_components(sdf: SignedDistanceField, px, py, pz):
    """Trilinear lookup on component tensors of any shape: returns
    (dist, gx, gy, gz, ok) (gpmp2_tpu/obstacle/sdf.py:436)."""
    nz, rows, cols = sdf.data.shape[-3:]
    cs = sdf.cell_size
    x = (px - sdf.origin[0]) / cs
    y = (py - sdf.origin[1]) / cs
    z = (pz - sdf.origin[2]) / cs
    ok = ((x >= 0.0) & (x <= cols - 1.0) & (y >= 0.0) & (y <= rows - 1.0)
          & (z >= 0.0) & (z <= nz - 1.0))
    xc, lci = _low_corner(x, cols)
    yc, lri = _low_corner(y, rows)
    zc, lzi = _low_corner(z, nz)
    fx = xc - lci.to(xc.dtype)
    fy = yc - lri.to(yc.dtype)
    fz = zc - lzi.to(zc.dtype)
    base = (lzi * rows + lri) * cols + lci
    flat = sdf.data.reshape(-1)
    d000, d010, d001, d011, d100, d110, d101, d111 = (
        flat[base + o] for o in _corner_offsets_3d(rows, cols))
    dist = ((1 - fy) * (1 - fx) * (1 - fz) * d000
            + fy * (1 - fx) * (1 - fz) * d010
            + (1 - fy) * fx * (1 - fz) * d001
            + fy * fx * (1 - fz) * d011
            + (1 - fy) * (1 - fx) * fz * d100
            + fy * (1 - fx) * fz * d110
            + (1 - fy) * fx * fz * d101
            + fy * fx * fz * d111)
    g_row = ((1 - fx) * (1 - fz) * (d010 - d000)
             + fx * (1 - fz) * (d011 - d001)
             + (1 - fx) * fz * (d110 - d100)
             + fx * fz * (d111 - d101))
    g_col = ((1 - fy) * (1 - fz) * (d001 - d000)
             + fy * (1 - fz) * (d011 - d010)
             + (1 - fy) * fz * (d101 - d100)
             + fy * fz * (d111 - d110))
    g_z = ((1 - fy) * (1 - fx) * (d100 - d000)
           + fy * (1 - fx) * (d110 - d010)
           + (1 - fy) * fx * (d101 - d001)
           + fy * fx * (d111 - d011))
    return dist, g_col / cs, g_row / cs, g_z / cs, ok


def sdf_lookup(sdf: SignedDistanceField, point):
    """Trilinear signed distance + world gradient + in-range mask.

    point: (..., 3) world (x, y, z) -> dist (...), grad (..., 3), ok (...)
    (SignedDistanceField::getSignedDistance, SDF.h:92-167)."""
    dist, gx, gy, gz, ok = sdf_lookup_components(
        sdf, point[..., 0], point[..., 1], point[..., 2])
    return dist, torch.stack([gx, gy, gz], dim=-1), ok

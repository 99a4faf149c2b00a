"""Signed distance fields with bilinear / trilinear differentiable lookups.

Port of gpmp2_tpu/obstacle/sdf.py (PlanarSDF.h and SignedDistanceField.h
semantics):

  - data layout (Y, X) in 2D and (Z, Y, X) in 3D; world -> cell:
    col = (x - ox)/cell, likewise row from y and slice from z;
  - interpolation over the low cell corner, which is clamped to size-2 so
    every corner index is in bounds (at the exact top boundary the
    fraction becomes 1 and the last interior cell is used);
  - gradient of the interpolant in world units, (x, y[, z]) order;
  - an out-of-range query returns `ok = False`; the hinge turns it into
    cost 0 and gradient 0 (ObstacleCost.h:31-38).

Cell indices are clamped after the float -> int cast: a NaN coordinate
casts to an arbitrary integer, and an out-of-bounds index into a CUDA
tensor is a device-side fault, where JAX's clipped take never faults.

Corner-packed table (`packed`, built by `pack_sdf` / `pack_planar_sdf`):
row l holds the 4 (2D) or 8 (3D) interpolation corners of cell l, so a
lookup reads one row per query. It is built exactly as the JAX package
builds its row-major table, by rolling the flat field by each corner
offset (rows that wrap past the top boundary get zero interpolation
weight). The JAX package's corner-major 2D layout and its gather screens
are not ported.

Per-problem worlds: `data` may carry one leading world axis, (W, rows,
cols) or (W, nz, rows, cols), with the packed table (W, cells, 4|8); the
origin and cell size are shared. A lookup on such a field takes query
tensors whose leading axis is W, and query row b reads world b.

Every lookup runs kernel K3 (ops/sdf_lookup.py) on CUDA tensors and its
plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from ..ops.sdf_lookup import corner_offsets, sdf_lookup_rows

__all__ = ["PlanarSDF", "SignedDistanceField", "pack_sdf", "pack_planar_sdf",
           "sdf_lookup_points", "sdf_lookup_components",
           "planar_sdf_lookup_components", "sdf_lookup", "planar_sdf_lookup"]


class _Field:
    """What the 2D and 3D fields share: validation, casting, the world axis."""

    DIM: ClassVar[int]

    def __post_init__(self):
        dim, name = self.DIM, type(self).__name__
        if tuple(self.origin.shape) != (dim,) or self.cell_size.dim() != 0:
            raise ValueError(f"{name}: origin must be ({dim},) and cell_size a "
                             f"scalar, got {tuple(self.origin.shape)} and "
                             f"{tuple(self.cell_size.shape)}")
        if self.data.dim() not in (dim, dim + 1) or min(self.grid) < 2:
            raise ValueError(f"{name}: data must be a {dim}-D grid, each size "
                             f">= 2, with at most one leading world axis, got "
                             f"{tuple(self.data.shape)}")
        if self.packed is not None:
            want = self.data.shape[:-dim] + (self.cells, 2 ** dim)
            if self.packed.shape != want or self.packed.dtype != self.data.dtype:
                raise ValueError(f"{name}: packed must be {tuple(want)} "
                                 f"{self.data.dtype}, got "
                                 f"{tuple(self.packed.shape)} {self.packed.dtype}")

    @property
    def grid(self) -> tuple:
        return tuple(self.data.shape[-self.DIM:])

    @property
    def cells(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n

    @property
    def num_worlds(self) -> int:
        """0 for one shared world, else the size of the world axis."""
        return self.data.shape[0] if self.data.dim() > self.DIM else 0

    def to(self, dtype=None, device=None):
        return dataclasses.replace(self, **{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(dtype=dtype, device=device)
            for f in dataclasses.fields(self)})

    def worlds(self, idx):
        """The same field with only the worlds `idx` (a per-problem field)."""
        return dataclasses.replace(
            self, data=self.data[idx],
            packed=None if self.packed is None else self.packed[idx])


@dataclasses.dataclass(frozen=True)
class PlanarSDF(_Field):
    """2D signed distance field. data is (rows, cols) = (Y, X), meters."""

    DIM: ClassVar[int] = 2
    origin: torch.Tensor  # (2,) world coords of cell (0, 0)
    cell_size: torch.Tensor  # ()
    data: torch.Tensor  # ([W,] rows, cols)
    packed: Optional[torch.Tensor] = None  # ([W,] rows*cols, 4) row-major


@dataclasses.dataclass(frozen=True)
class SignedDistanceField(_Field):
    """3D signed distance field. data is (Z, Y, X), meters."""

    DIM: ClassVar[int] = 3
    origin: torch.Tensor  # (3,) world coords of cell (0, 0, 0)
    cell_size: torch.Tensor  # ()
    data: torch.Tensor  # ([W,] Z, Y, X)
    packed: Optional[torch.Tensor] = None  # ([W,] Z*Y*X, 8) row-major


def _pack(sdf):
    if sdf.packed is not None:
        return sdf
    flat = sdf.data.reshape(sdf.data.shape[:-sdf.DIM] + (-1,))
    packed = torch.stack([torch.roll(flat, -off, dims=-1)
                          for off in corner_offsets(sdf.grid)], dim=-1)
    return dataclasses.replace(sdf, packed=packed)


def pack_sdf(sdf: SignedDistanceField) -> SignedDistanceField:
    """`sdf` with its corner-packed table: packed[l, k] = flat[l + off_k]
    with wraparound at the top boundary, which clamped lookups give zero
    weight (gpmp2_tpu/obstacle/sdf.py:100, row-major)."""
    return _pack(sdf)


def pack_planar_sdf(sdf: PlanarSDF) -> PlanarSDF:
    """2D analog of `pack_sdf`: one 4-corner row per cell
    (gpmp2_tpu/obstacle/sdf.py:132, row-major)."""
    return _pack(sdf)


def sdf_lookup_points(sdf, points):
    """Lookup of points (..., P), P >= the field's dimension (coordinates
    past it are ignored): returns (dist, gx, gy[, gz], ok), each of shape
    points.shape[:-1]. On a per-problem field the leading axis of `points`
    is the world axis."""
    W = sdf.num_worlds
    if W and (points.dim() < 2 or points.shape[0] != W):
        raise ValueError(f"a field of {W} worlds needs points with leading "
                         f"axis {W}, got {tuple(points.shape)}")
    lead = points.shape[:-1]
    flat = points.reshape(-1, points.shape[-1])
    qpw = flat.shape[0] // W if W else 0
    if W and qpw == 0:
        raise ValueError("a per-problem field needs at least one query per world")
    if sdf.packed is not None:
        table = sdf.packed.reshape(-1, 2 ** sdf.DIM)
    else:
        table = sdf.data.reshape(-1)
    out = sdf_lookup_rows(flat, table, sdf.origin, sdf.cell_size, sdf.grid, qpw)
    return tuple(t.reshape(lead) for t in out)


def sdf_lookup_components(sdf: SignedDistanceField, px, py, pz):
    """Trilinear lookup on component tensors of one shape: returns
    (dist, gx, gy, gz, ok) (gpmp2_tpu/obstacle/sdf.py:436)."""
    return sdf_lookup_points(sdf, torch.stack([px, py, pz], dim=-1))


def planar_sdf_lookup_components(sdf: PlanarSDF, px, py):
    """Bilinear lookup on component tensors of one shape: returns
    (dist, gx, gy, ok) (gpmp2_tpu/obstacle/sdf.py:396)."""
    return sdf_lookup_points(sdf, torch.stack([px, py], dim=-1))


def sdf_lookup(sdf: SignedDistanceField, point):
    """Trilinear signed distance + world gradient + in-range mask.

    point: (..., 3) world (x, y, z) -> dist (...), grad (..., 3), ok (...)
    (SignedDistanceField::getSignedDistance, SDF.h:92-167)."""
    dist, gx, gy, gz, ok = sdf_lookup_points(sdf, point)
    return dist, torch.stack([gx, gy, gz], dim=-1), ok


def planar_sdf_lookup(sdf: PlanarSDF, point):
    """Bilinear signed distance + world gradient + in-range mask.

    point: (..., 2) world (x, y) -> dist (...), grad (..., 2), ok (...)
    (PlanarSDF::getSignedDistance, PlanarSDF.h:106-118)."""
    dist, gx, gy, ok = sdf_lookup_points(sdf, point)
    return dist, torch.stack([gx, gy], dim=-1), ok

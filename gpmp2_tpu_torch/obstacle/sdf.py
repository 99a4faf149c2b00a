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

Corner-packed tables (`packed`, built by `pack_sdf` / `pack_planar_sdf`):
row l holds the 4 (2D) or 8 (3D) interpolation corners of cell l, so a
lookup reads one row per query. They are built exactly as the JAX package
builds them, by rolling the flat field by each corner offset (rows that
wrap past the top boundary get zero interpolation weight). Opt-in forms,
as in the JAX package (none is applied by default):
  - a 3D table stored in float16 or bfloat16 (`pack_sdf(sdf, dtype)`, the
    planner's GPMP2_TPU_PACK_DTYPE): the field's values are cast, then
    rolled; the lookup converts the corners to the query type;
  - the corner-major 2D table ([W,] 4, cells) (`pack_planar_sdf(sdf,
    corner_major=True)`). The layout is the explicit `corner_major` field,
    where the JAX package infers it from the table's shape and reads the
    table of a 2 x 2 world as row-major.

Screens (3D, one shared world; opt-in): `screen_boxes` (K, 2, 3), the
world [lo; hi] hulls of the obstacle boxes' occupied voxel centres
(`datasets.dataset_screen_boxes`), or the min-pooled `coarse` table of
`screen_sdf`. Given a hinge threshold (`screen_thresh`), a query whose
lower bound already clears it returns the bound, a zero gradient and its
in-range mask, and K3 skips its row read; the hinge is zero there either
way (gpmp2_tpu/obstacle/sdf.py:298-392). The hull screen wins when both
are present.

Per-problem worlds: `data` may carry one leading world axis, (W, rows,
cols) or (W, nz, rows, cols), with the packed table (W, cells, 4|8) or
(W, 4, cells); the origin and cell size are shared. A lookup on such a
field takes query tensors whose leading axis is W, and query row b reads
world b.

Every lookup runs kernel K3 (ops/sdf_lookup.py) on CUDA tensors and its
plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch
import torch.nn.functional as F

from ..ops.sdf_lookup import NARROW_DTYPES, corner_offsets, sdf_lookup_rows

__all__ = ["PlanarSDF", "SignedDistanceField", "pack_sdf", "pack_planar_sdf",
           "screen_sdf", "sdf_lookup_points", "sdf_lookup_components",
           "planar_sdf_lookup_components", "sdf_lookup", "planar_sdf_lookup"]


class _Field:
    """What the 2D and 3D fields share: validation, casting, the world axis."""

    DIM: ClassVar[int]
    corner_major = False  # the packed table's layout (a PlanarSDF field)

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
            lead = self.data.shape[:-dim]
            want = lead + ((4, self.cells) if self.corner_major
                           else (self.cells, 2 ** dim))
            dtypes = (self.data.dtype,) + (NARROW_DTYPES if dim == 3 else ())
            if self.packed.shape != want or self.packed.dtype not in dtypes:
                raise ValueError(f"{name}: packed must be {tuple(want)} of "
                                 f"{', '.join(map(str, dtypes))}, got "
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
        """The field in `dtype` on `device`; a narrow packed table keeps its
        storage type."""
        def cast(t):
            narrow = t is self.packed and t.dtype in NARROW_DTYPES
            return t.to(dtype=None if narrow else dtype, device=device)

        return dataclasses.replace(self, **{
            f.name: cast(getattr(self, f.name)) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

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
    packed: Optional[torch.Tensor] = None  # ([W,] cells, 4), or ([W,] 4, cells)
    corner_major: bool = False  # the packed table's layout


@dataclasses.dataclass(frozen=True)
class SignedDistanceField(_Field):
    """3D signed distance field. data is (Z, Y, X), meters."""

    DIM: ClassVar[int] = 3
    origin: torch.Tensor  # (3,) world coords of cell (0, 0, 0)
    cell_size: torch.Tensor  # ()
    data: torch.Tensor  # ([W,] Z, Y, X)
    packed: Optional[torch.Tensor] = None  # ([W,] Z*Y*X, 8) row-major
    coarse: Optional[torch.Tensor] = None  # (zc, rc, cc) min-pooled bounds
    coarse_cell: Optional[torch.Tensor] = None  # () cell_size * factor
    screen_boxes: Optional[torch.Tensor] = None  # (K, 2, 3) world [lo; hi] hulls

    def __post_init__(self):
        super().__post_init__()
        screens = (self.coarse, self.coarse_cell, self.screen_boxes)
        if self.num_worlds and any(t is not None for t in screens):
            raise ValueError("SignedDistanceField: a screen needs one shared world")
        if (self.coarse is None) != (self.coarse_cell is None):
            raise ValueError("SignedDistanceField: coarse and coarse_cell go together")
        for name, t, ok in (
                ("coarse", self.coarse, lambda t: t.dim() == 3),
                ("coarse_cell", self.coarse_cell, lambda t: t.dim() == 0),
                ("screen_boxes", self.screen_boxes,
                 lambda t: t.dim() == 3 and tuple(t.shape[1:]) == (2, 3) and t.shape[0] > 0)):
            if t is not None and (not ok(t) or t.dtype != self.data.dtype):
                raise ValueError(f"SignedDistanceField: bad {name} {tuple(t.shape)} "
                                 f"{t.dtype} for a {self.data.dtype} field")


def _pack(sdf, dtype=None, corner_major=False):
    if sdf.packed is not None:
        return sdf
    flat = sdf.data.reshape(sdf.data.shape[:-sdf.DIM] + (-1,))
    if dtype is not None:
        flat = flat.to(dtype)
    packed = torch.stack([torch.roll(flat, -off, dims=-1)
                          for off in corner_offsets(sdf.grid)],
                         dim=-2 if corner_major else -1)
    return dataclasses.replace(sdf, packed=packed)


def pack_sdf(sdf: SignedDistanceField, dtype=None) -> SignedDistanceField:
    """`sdf` with its corner-packed table: packed[l, k] = flat[l + off_k]
    with wraparound at the top boundary, which clamped lookups give zero
    weight (gpmp2_tpu/obstacle/sdf.py:100). `dtype` (float16 or bfloat16)
    stores the table narrower: the field is cast, then rolled, as the JAX
    package does; a lookup converts the corners to the query type."""
    if dtype is not None and dtype not in NARROW_DTYPES + (sdf.data.dtype,):
        raise ValueError(f"pack_sdf: dtype must be one of {NARROW_DTYPES} or the "
                         f"field's {sdf.data.dtype}, got {dtype}")
    return _pack(sdf, dtype)


def pack_planar_sdf(sdf: PlanarSDF, corner_major: bool = False) -> PlanarSDF:
    """2D analog of `pack_sdf` (gpmp2_tpu/obstacle/sdf.py:132): one 4-corner
    row per cell, ([W,] cells, 4), or with `corner_major` one row per
    corner, ([W,] 4, cells). A field that already has a table keeps it."""
    if sdf.packed is not None:
        return sdf
    return _pack(dataclasses.replace(sdf, corner_major=corner_major),
                 corner_major=corner_major)


def screen_sdf(sdf: SignedDistanceField, factor: int = 8) -> SignedDistanceField:
    """`sdf` with its coarse screen table (gpmp2_tpu/obstacle/sdf.py:164):
    the field min-pooled over (factor + 1)-wide windows at stride `factor`,
    padded at the high end only (the +1 halo covers the 8 trilinear
    corners of any point in the block), so coarse[c] <= the interpolated
    distance of every point of block c; a window wholly in the padding
    takes the field's minimum. coarse_cell = cell_size * factor."""
    if sdf.coarse is not None:
        return sdf
    if sdf.num_worlds:
        raise ValueError("screen_sdf: a screen needs one shared world")
    data = sdf.data
    padded = F.pad(-data[None, None], (0, factor) * 3, value=-float("inf"))
    pooled = -F.max_pool3d(padded, kernel_size=factor + 1, stride=factor)[0, 0]
    pooled = torch.where(torch.isfinite(pooled), pooled, data.min())
    return dataclasses.replace(sdf, coarse=pooled.contiguous(),
                               coarse_cell=sdf.cell_size * factor)


def _per_query(thresh, lead, dtype, device):
    """The thresholds of queries of shape `lead` as K3 takes them: (S,),
    query i reading [i % S]. A scalar or a vector over the last query axis
    stays as it is; anything else is broadcast to every query."""
    t = torch.as_tensor(thresh, dtype=dtype, device=device)
    if t.dim() > len(lead) or any(a not in (1, b) for a, b in zip(t.shape[::-1], lead[::-1])):
        raise ValueError(f"screen_thresh {tuple(t.shape)} does not broadcast to "
                         f"the queries {tuple(lead)}")
    if t.numel() == 1:
        return t.reshape(1)
    if t.dim() == 1 and len(lead) and t.shape[0] == lead[-1]:
        return t.contiguous()
    return t.expand(lead).reshape(-1)


def sdf_lookup_points(sdf, points, screen_thresh=None):
    """Lookup of points (..., P), P >= the field's dimension (coordinates
    past it are ignored): returns (dist, gx, gy[, gz], ok), each of shape
    points.shape[:-1]. On a per-problem field the leading axis of `points`
    is the world axis. `screen_thresh` (broadcastable to the queries) is
    the hinge threshold of the field's screen, if it has one; it is
    ignored otherwise."""
    W = sdf.num_worlds
    if W and (points.dim() < 2 or points.shape[0] != W):
        raise ValueError(f"a field of {W} worlds needs points with leading "
                         f"axis {W}, got {tuple(points.shape)}")
    lead = points.shape[:-1]
    flat = points.reshape(-1, points.shape[-1])
    qpw = flat.shape[0] // W if W else 0
    if W and qpw == 0:
        raise ValueError("a per-problem field needs at least one query per world")
    variant = {}
    if sdf.packed is None:
        table = sdf.data.reshape(-1)
    elif sdf.corner_major:
        table = sdf.packed.reshape(-1, 4, sdf.cells)
        variant["corner_major"] = True
    else:
        table = sdf.packed.reshape(-1, 2 ** sdf.DIM)
    boxes, coarse = getattr(sdf, "screen_boxes", None), getattr(sdf, "coarse", None)
    if screen_thresh is not None and (boxes is not None or coarse is not None):
        variant["thresh"] = _per_query(screen_thresh, lead, points.dtype, points.device)
        if boxes is not None:
            variant["boxes"] = boxes.contiguous()
        else:
            variant.update(coarse=coarse.contiguous(), coarse_cell=sdf.coarse_cell)
    out = sdf_lookup_rows(flat, table, sdf.origin, sdf.cell_size, sdf.grid, qpw,
                          **variant)
    return tuple(t.reshape(lead) for t in out)


def sdf_lookup_components(sdf: SignedDistanceField, px, py, pz):
    """Trilinear lookup on component tensors of one shape: returns
    (dist, gx, gy, gz, ok) (gpmp2_tpu/obstacle/sdf.py:436)."""
    return sdf_lookup_points(sdf, torch.stack([px, py, pz], dim=-1))


def planar_sdf_lookup_components(sdf: PlanarSDF, px, py):
    """Bilinear lookup on component tensors of one shape: returns
    (dist, gx, gy, ok) (gpmp2_tpu/obstacle/sdf.py:396)."""
    return sdf_lookup_points(sdf, torch.stack([px, py], dim=-1))


def sdf_lookup(sdf: SignedDistanceField, point, screen_thresh=None):
    """Trilinear signed distance + world gradient + in-range mask.

    point: (..., 3) world (x, y, z) -> dist (...), grad (..., 3), ok (...)
    (SignedDistanceField::getSignedDistance, SDF.h:92-167). With
    `screen_thresh` and a screen on the field, a screened query returns
    its bound and a zero gradient (gpmp2_tpu/obstacle/sdf.py:254)."""
    dist, gx, gy, gz, ok = sdf_lookup_points(sdf, point, screen_thresh)
    return dist, torch.stack([gx, gy, gz], dim=-1), ok


def planar_sdf_lookup(sdf: PlanarSDF, point):
    """Bilinear signed distance + world gradient + in-range mask.

    point: (..., 2) world (x, y) -> dist (...), grad (..., 2), ok (...)
    (PlanarSDF::getSignedDistance, PlanarSDF.h:106-118)."""
    dist, gx, gy, ok = sdf_lookup_points(sdf, point)
    return dist, torch.stack([gx, gy], dim=-1), ok

"""SDF lookup with its corner gather: kernel K3, its plain twin, dispatch.

`sdf_lookup_cuda` launches the hand-written CUDA kernel
(csrc/sdf_lookup.cu), which replaces the TPU row-gather kernels P1-P9
(profile_dma2.py:120,181, profile_dma3.py:60, profile_dma4.py:82-146,
profile_dma5.py:83,102,158, profile_dma6.py:61-166, profile_dma7.py:58,
profile_dma8.py:68,146, profile_dma9.py:78, profile_dma_gather.py:214):
each computes `table[idx]` over a corner-packed SDF table, the gather stage
of gpmp2_tpu/obstacle/sdf.py:sdf_lookup (:254), sdf_lookup_components
(:436) and planar_sdf_lookup_components (:396). The kernel runs that whole
lookup, so the gathered rows stay in registers. `sdf_lookup_torch` is the
plain PyTorch version of the same function: a `table[idx]` row gather (or
the per-corner gather of the raw field) and the same arithmetic.
`sdf_lookup_rows` takes the plain version for CPU tensors and the kernel
for CUDA tensors; there is no other path.

Operands (both versions):
- pts (N, P): query points, P >= dim; coordinate k of point i is
  pts[i, k] (x, y[, z]); the kernel reads them in place, so K2's sphere
  centres (N, 3) serve a planar lookup too;
- table, in one of three layouts (`grid` is (rows, cols) or (nz, rows,
  cols), cells its product, W the number of worlds):
  - raw: the field flattened to (W * cells,);
  - packed: (W * cells, 2^dim) corner rows; a 3D table may be stored in
    float16 or bfloat16 under float32 or float64 queries, its corners
    converted to the query type after the read
    (gpmp2_tpu/obstacle/sdf.py:100-122, 344-345);
  - corner-major (2D only, `corner_major=True`): (W, 4, cells), corner k
    of cell l at [w, k, l] (gpmp2_tpu/obstacle/sdf.py:132-161); the
    kernel reads it in place or, where `corner_major_route` says so,
    copies it into packed rows first (a scratch the wrapper allocates);
- origin (>= dim,), cell (): the grid's world frame;
- queries_per_world: 0 for one shared world, else query i reads world
  i // queries_per_world.

Screens (3D, one shared world; gpmp2_tpu/obstacle/sdf.py:298-338,
390-392): with `thresh` (S,) given, query i's threshold is thresh[i % S]
(S divides N; the planner's per-sphere eps_total needs no expansion to N)
and a lower bound of the distance decides whether the query needs its row:
- hull screen (`boxes` (K, 2, 3), world [lo; hi] corners of the occupied
  voxel-centre hulls): bound = min_k |p - box_k| - sqrt(3) cell, screened
  where bound > max(thresh, 0);
- coarse screen (`coarse` (zc, rc, cc) min-pooled bounds at `coarse_cell`
  resolution): bound = coarse at the point's coarse cell, its index
  clipped then truncated, screened where bound > thresh.
A screened query returns dist = bound, a zero gradient and its in-range
mask; the hinge is zero there either way. The kernel skips the screened
query's row read; on the card the screens run in a persistent kernel
(csrc/sdf_lookup.cu, `sdf_screen_kernel`), whose grid the launcher sizes
to the blocks that fit on the card at once.

Returns (dist, gx, gy[, gz], ok), each (N,): distances and world-frame
gradients in the input dtype, ok the in-range mask.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..utils import trace

__all__ = ["corner_offsets", "corner_major_route", "screen_bound", "sdf_lookup_torch",
           "sdf_lookup_cuda", "sdf_lookup_rows", "NARROW_DTYPES"]

# storage types of a packed 3D table narrower than its queries, in the
# order of the kernel's `storage` code (1, 2)
NARROW_DTYPES = (torch.float16, torch.bfloat16)
# a launch's cost in bytes of memory time (~1.3 us at 3.35 TB/s), for
# corner_major_route
LAUNCH_BYTES = 4 << 20
# hull boxes the kernel stages in shared memory (48 KB of float64)
_MAX_SCREEN_BOXES = 1024
_SQRT3 = math.sqrt(3.0)


def corner_offsets(grid):
    """Flat offsets of a cell's corners from its low corner, in the packed
    rows' order: d00 d10 d01 d11 in 2D (row, col), d000 d010 d001 d011
    d100 d110 d101 d111 in 3D (z, row, col)."""
    rows, cols = grid[-2], grid[-1]
    offs = [0, cols, 1, cols + 1]
    if len(grid) == 3:
        offs += [rows * cols + o for o in offs]
    return offs


def corner_major_route(N, worlds, cells, itemsize):
    """How the kernel reads a corner-major table of `worlds` x `cells`
    cells for N queries of `itemsize`-byte values: "interleaved" (the
    table copied into packed rows, then one row a query) or "direct" (four
    loads a query, each its own 32-B sector). The copy moves the table
    twice, 8 * itemsize bytes a cell, and its launch costs about
    LAUNCH_BYTES of memory time; it saves three sectors, 96 B, a query. So:
    interleaved where 8 * itemsize * worlds * cells + LAUNCH_BYTES <= 96 *
    N. PointRobot2D's 999,424 queries on OneObstacle's 90,000 cells: 7 MB
    against 96 MB, interleaved; MultiWorld2D's 270,336 queries on 8,192
    worlds of 4,096 cells: 1.08 GB against 26 MB, direct."""
    need = 8 * itemsize * worlds * cells + LAUNCH_BYTES
    return "interleaved" if need <= 96 * N else "direct"


def _low_corner(coord, size):
    """Clamped coordinate and its low cell index in [0, size - 2]; the index
    is clamped after the float -> int cast, so NaN gives an in-bounds index."""
    c = torch.clamp(coord, 0.0, size - 1.0)
    idx = torch.floor(c).to(torch.int64).clamp(0, size - 2)
    return c, idx


def screen_bound(pts, origin, cell, thresh, boxes=None, coarse=None, coarse_cell=None):
    """The screen's lower bound of each query's distance (N,) and the mask
    of the queries it screens, in the arithmetic order of the kernel (no
    fused multiply-adds), so both screen the same queries."""
    bound = _screen_bound(pts, origin, cell, boxes, coarse, coarse_cell)
    t = thresh.repeat(pts.shape[0] // thresh.shape[0])
    if boxes is not None:
        t = torch.clamp(t, min=0.0)
    return bound, ~(bound <= t)


def _screen_bound(pts, origin, cell, boxes, coarse, coarse_cell):
    p = pts[:, :3]
    if boxes is not None:
        zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
        lo, hi = boxes[:, 0, :], boxes[:, 1, :]
        d = torch.maximum(torch.maximum(lo - p[:, None, :], p[:, None, :] - hi), zero)
        hull = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                          + d[..., 2] * d[..., 2])
        return hull.min(-1).values - cell * _SQRT3
    zc, rc, cc = coarse.shape
    # clipped, then truncated; NaN gives index 0, as the JAX cast does
    idx = [torch.clamp(torch.nan_to_num((p[:, k] - origin[k]) / coarse_cell, nan=0.0),
                       0.0, size - 1.0).to(torch.int64)
           for k, size in enumerate((cc, rc, zc))]
    return coarse.reshape(-1)[(idx[2] * rc + idx[1]) * cc + idx[0]]


def sdf_lookup_torch(pts, table, origin, cell, grid, queries_per_world=0, *,
                     corner_major=False, thresh=None, boxes=None, coarse=None,
                     coarse_cell=None):
    """Plain PyTorch version of K3 (see the module docstring)."""
    dim = len(grid)
    N = pts.shape[0]
    sizes = (grid[-1], grid[-2], grid[0])[:dim]  # x -> cols, y -> rows, z -> nz
    coords = [(pts[:, k] - origin[k]) / cell for k in range(dim)]
    ok = torch.ones(N, dtype=torch.bool, device=pts.device)
    fr, idx = [], []
    for c, size in zip(coords, sizes):
        ok = ok & (c >= 0.0) & (c <= size - 1.0)
        cc, i = _low_corner(c, size)
        fr.append(cc - i.to(cc.dtype))
        idx.append(i)
    rows, cols = grid[-2], grid[-1]
    base = idx[1] * cols + idx[0]
    if dim == 3:
        base = base + idx[2] * (rows * cols)
    cells = 1
    for g in grid:
        cells *= g
    world = None
    if queries_per_world:
        world = torch.arange(N, device=pts.device) // queries_per_world
        base = base + world * cells
    if corner_major:
        flat = table.reshape(-1)
        start = base if world is None else base + 3 * cells * world
        v = [flat[start + k * cells] for k in range(4)]
    elif table.dim() == 2:
        v = table[base].to(pts.dtype).unbind(-1)
    else:
        v = [table[base + o] for o in corner_offsets(grid)]
    fx, fy = fr[0], fr[1]
    if dim == 2:
        d00, d10, d01, d11 = v
        dist = ((1 - fy) * (1 - fx) * d00 + fy * (1 - fx) * d10
                + (1 - fy) * fx * d01 + fy * fx * d11)
        g_row = (1 - fx) * (d10 - d00) + fx * (d11 - d01)
        g_col = (1 - fy) * (d01 - d00) + fy * (d11 - d10)
        return dist, g_col / cell, g_row / cell, ok
    fz = fr[2]
    d000, d010, d001, d011, d100, d110, d101, d111 = v
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
    out = [dist, g_col / cell, g_row / cell, g_z / cell]
    if thresh is not None:
        bound, screened = screen_bound(pts, origin, cell, thresh, boxes, coarse,
                                       coarse_cell)
        zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
        out = [torch.where(screened, bound, out[0])] + [torch.where(screened, zero, g)
                                                       for g in out[1:]]
    return (*out, ok)


def _check_operands(pts, table, origin, cell, grid, queries_per_world, corner_major,
                    thresh, boxes, coarse, coarse_cell):
    """Raise unless the operands are what the kernel takes."""
    dim = len(grid)
    if dim not in (2, 3) or min(grid) < 2:
        raise ValueError(f"grid must be 2 or 3 sizes, each >= 2, got {tuple(grid)}")
    if pts.dim() != 2 or pts.shape[1] < dim:
        raise ValueError(f"pts must be (N, P) with P >= {dim}, got {tuple(pts.shape)}")
    dtype, device = pts.dtype, pts.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pts must be float32 or float64, got {dtype}")
    cells = 1
    for g in grid:
        cells *= g
    N = pts.shape[0]
    if queries_per_world < 0 or (queries_per_world and N % queries_per_world):
        raise ValueError(f"queries_per_world {queries_per_world} must be 0 or "
                         f"divide the {N} queries")
    worlds = N // queries_per_world if queries_per_world else 1
    k = 2 ** dim
    if corner_major:
        if dim != 2:
            raise ValueError("a corner-major table is 2D only")
        want = (worlds, 4, cells)
    else:
        want = (worlds * cells, k) if table.dim() == 2 else (worlds * cells,)
    narrow = (dim == 3 and table.dim() == 2 and not corner_major
              and table.dtype in NARROW_DTYPES)
    operands = [("pts", pts, None, dtype), ("table", table, want,
                                             table.dtype if narrow else dtype),
                ("origin", origin, None, dtype), ("cell", cell, (), dtype)]
    if thresh is not None:
        if dim != 3 or queries_per_world:
            raise ValueError("a screen needs a 3D field of one shared world")
        if (boxes is None) == (coarse is None):
            raise ValueError("a screen takes boxes or a coarse table, one of the two")
        if thresh.dim() != 1 or thresh.shape[0] == 0 or N % thresh.shape[0]:
            raise ValueError(f"thresh must be (S,) with S dividing the {N} queries, "
                             f"got {tuple(thresh.shape)}")
        operands.append(("thresh", thresh, None, dtype))
        if boxes is not None:
            if boxes.dim() != 3 or tuple(boxes.shape[1:]) != (2, 3) or not (
                    1 <= boxes.shape[0] <= _MAX_SCREEN_BOXES):
                raise ValueError(f"boxes must be (K, 2, 3) with 1 <= K <= "
                                 f"{_MAX_SCREEN_BOXES}, got {tuple(boxes.shape)}")
            operands.append(("boxes", boxes, None, dtype))
        else:
            if coarse.dim() != 3 or coarse_cell is None:
                raise ValueError("coarse must be (zc, rc, cc) with its coarse_cell")
            operands += [("coarse", coarse, None, dtype),
                         ("coarse_cell", coarse_cell, (), dtype)]
    elif boxes is not None or coarse is not None:
        raise ValueError("a screen needs its thresholds")
    for name, t, shape, want_dtype in operands:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != want_dtype:
            raise ValueError(f"{name} must be {want_dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origin.dim() != 1 or origin.shape[0] < dim:
        raise ValueError(f"origin must be ({dim},), got {tuple(origin.shape)}")
    if table.dim() == 2 and table.data_ptr() % 16:
        raise ValueError("a packed table must start on a 16-byte boundary")


def sdf_lookup_cuda(pts, table, origin, cell, grid, queries_per_world=0, *,
                    corner_major=False, thresh=None, boxes=None, coarse=None,
                    coarse_cell=None):
    """Launch kernel K3 (csrc/sdf_lookup.cu) on CUDA tensors; same semantics
    as `sdf_lookup_torch`. Raises on what the kernel does not take."""
    grid = tuple(int(g) for g in grid)
    _check_operands(pts, table, origin, cell, grid, queries_per_world, corner_major,
                    thresh, boxes, coarse, coarse_cell)
    dim = len(grid)
    N = pts.shape[0]
    out = torch.empty((dim + 1, N), dtype=pts.dtype, device=pts.device)
    ok = torch.empty((N,), dtype=torch.bool, device=pts.device)
    if N == 0:
        return (*out.unbind(0), ok)
    nz = grid[0] if dim == 3 else 1
    layout = int(table.dim() == 2)
    scratch = ctypes.c_void_p(0)
    if corner_major:
        worlds, _, cells = table.shape
        layout = 2
        if corner_major_route(N, worlds, cells, table.element_size()) == "interleaved":
            layout = 3
            rows = torch.empty((worlds * cells, 4), dtype=table.dtype, device=table.device)
            scratch = rows.data_ptr()
    storage = (NARROW_DTYPES.index(table.dtype) + 1
               if table.dtype in NARROW_DTYPES and dim == 3 else 0)
    screen = 0 if thresh is None else (1 if boxes is not None else 2)
    null = ctypes.c_void_p(0)
    n_thresh = 0 if thresh is None else thresh.shape[0]
    if screen == 1:
        screen_table, screen_shape, ccell = boxes.data_ptr(), (boxes.shape[0], 0, 0), null
    elif screen == 2:
        screen_table, screen_shape, ccell = (coarse.data_ptr(), tuple(coarse.shape),
                                             coarse_cell.data_ptr())
    else:
        screen_table, screen_shape, ccell = null, (0, 0, 0), null
    lib = _build.kernels_lib()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpmp2_sdf_lookup(
            pts.data_ptr(), pts.shape[1], table.data_ptr(), origin.data_ptr(),
            cell.data_ptr(), out.data_ptr(), ok.data_ptr(), N,
            queries_per_world, nz, grid[-2], grid[-1], dim, layout, storage,
            int(pts.dtype == torch.float64), screen,
            null if thresh is None else thresh.data_ptr(), n_thresh, screen_table,
            ccell, *screen_shape, scratch, ctypes.c_void_p(stream))
    _build.check(rc, "sdf_lookup launch")
    trace.count("launches.k3")
    return (*out.unbind(0), ok)


def sdf_lookup_rows(pts, table, origin, cell, grid, queries_per_world=0, **variant):
    """The lookup of N query points (see the module docstring): kernel K3
    for CUDA tensors, the plain version for CPU tensors. `variant` holds
    the keywords of a corner-major table or a screen."""
    if pts.is_cuda:
        return sdf_lookup_cuda(pts.contiguous(), table, origin, cell, grid,
                               queries_per_world, **variant)
    if pts.device.type == "cpu":
        return sdf_lookup_torch(pts, table, origin, cell, grid, queries_per_world,
                                **variant)
    raise ValueError(f"no SDF lookup for device {pts.device}")

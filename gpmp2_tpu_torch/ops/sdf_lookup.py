"""SDF lookup with its corner gather: kernel K3, its plain twin, dispatch.

`sdf_lookup_cuda` launches the hand-written CUDA kernel
(csrc/sdf_lookup.cu), which replaces the TPU row-gather kernels P1-P9
(profile_dma2.py:120,181, profile_dma3.py:60, profile_dma4.py:82-146,
profile_dma5.py:83,102,158, profile_dma6.py:61-166, profile_dma7.py:58,
profile_dma8.py:68,146, profile_dma9.py:78, profile_dma_gather.py:214):
each computes `table[idx]` over a corner-packed SDF table, the gather stage
of gpmp2_tpu/obstacle/sdf.py:sdf_lookup_components (:436) and
planar_sdf_lookup_components (:396). The kernel runs that whole lookup, so
the gathered rows stay in registers. `sdf_lookup_torch` is the plain
PyTorch version of the same function: a `table[idx]` row gather (or the
per-corner gather of the raw field) and the same arithmetic.
`sdf_lookup_rows` takes the plain version for CPU tensors and the kernel
for CUDA tensors; there is no other path.

Operands (both versions):
- pts (N, P): query points, P >= dim; coordinate k of point i is
  pts[i, k] (x, y[, z]); the kernel reads them in place, so K2's sphere
  centres (N, 3) serve a planar lookup too;
- table: the packed rows (W * cells, 2^dim), or the raw field flattened
  to (W * cells,); `grid` is (rows, cols) or (nz, rows, cols);
- origin (>= dim,), cell (): the grid's world frame;
- queries_per_world: 0 for one shared world, else query i reads world
  i // queries_per_world.

Returns (dist, gx, gy[, gz], ok), each (N,): distances and world-frame
gradients in the input dtype, ok the in-range mask.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["corner_offsets", "sdf_lookup_torch", "sdf_lookup_cuda",
           "sdf_lookup_rows"]


def corner_offsets(grid):
    """Flat offsets of a cell's corners from its low corner, in the packed
    rows' order: d00 d10 d01 d11 in 2D (row, col), d000 d010 d001 d011
    d100 d110 d101 d111 in 3D (z, row, col)."""
    rows, cols = grid[-2], grid[-1]
    offs = [0, cols, 1, cols + 1]
    if len(grid) == 3:
        offs += [rows * cols + o for o in offs]
    return offs


def _low_corner(coord, size):
    """Clamped coordinate and its low cell index in [0, size - 2]; the index
    is clamped after the float -> int cast, so NaN gives an in-bounds index."""
    c = torch.clamp(coord, 0.0, size - 1.0)
    idx = torch.floor(c).to(torch.int64).clamp(0, size - 2)
    return c, idx


def sdf_lookup_torch(pts, table, origin, cell, grid, queries_per_world=0):
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
    if queries_per_world:
        cells = 1
        for g in grid:
            cells *= g
        world = torch.arange(N, device=pts.device) // queries_per_world
        base = base + world * cells
    if table.dim() == 2:
        v = table[base].unbind(-1)
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
    return dist, g_col / cell, g_row / cell, g_z / cell, ok


def _check_operands(pts, table, origin, cell, grid, queries_per_world):
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
    want = (worlds * cells, k) if table.dim() == 2 else (worlds * cells,)
    for name, t, shape in (("pts", pts, None), ("table", table, want),
                           ("origin", origin, None), ("cell", cell, ())):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} like pts, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if origin.dim() != 1 or origin.shape[0] < dim:
        raise ValueError(f"origin must be ({dim},), got {tuple(origin.shape)}")
    if table.dim() == 2 and table.data_ptr() % 16:
        raise ValueError("a packed table must start on a 16-byte boundary")


def sdf_lookup_cuda(pts, table, origin, cell, grid, queries_per_world=0):
    """Launch kernel K3 (csrc/sdf_lookup.cu) on CUDA tensors; same semantics
    as `sdf_lookup_torch`. Raises on what the kernel does not take."""
    grid = tuple(int(g) for g in grid)
    _check_operands(pts, table, origin, cell, grid, queries_per_world)
    dim = len(grid)
    N = pts.shape[0]
    out = torch.empty((dim + 1, N), dtype=pts.dtype, device=pts.device)
    ok = torch.empty((N,), dtype=torch.bool, device=pts.device)
    if N == 0:
        return (*out.unbind(0), ok)
    nz = grid[0] if dim == 3 else 1
    lib = _build.kernels_lib()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpmp2_sdf_lookup(
            pts.data_ptr(), pts.shape[1], table.data_ptr(), origin.data_ptr(),
            cell.data_ptr(), out.data_ptr(), ok.data_ptr(), N,
            queries_per_world, nz, grid[-2], grid[-1], dim,
            int(table.dim() == 2), int(pts.dtype == torch.float64),
            ctypes.c_void_p(stream))
    _build.check(rc, "sdf_lookup launch")
    sdf_lookup_cuda.launches += 1
    return (*out.unbind(0), ok)


sdf_lookup_cuda.launches = 0


def sdf_lookup_rows(pts, table, origin, cell, grid, queries_per_world=0):
    """The lookup of N query points (see the module docstring): kernel K3
    for CUDA tensors, the plain version for CPU tensors."""
    if pts.is_cuda:
        return sdf_lookup_cuda(pts.contiguous(), table, origin, cell, grid,
                               queries_per_world)
    if pts.device.type == "cpu":
        return sdf_lookup_torch(pts, table, origin, cell, grid, queries_per_world)
    raise ValueError(f"no SDF lookup for device {pts.device}")

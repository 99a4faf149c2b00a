"""Checkpointing and file IO for SDFs and trajectories.

Port of gpmp2_tpu/utils/fileio.py: npz archives in place of the
reference's Boost-serialization save/load (SignedDistanceField.cpp:13-70),
with the JAX package's keys and array types, so that a file either package
writes loads in the other; and the reader of the reference's `.vol` pair
(fileUtils.cpp:16-60). Loaders put their tensors on `device` (default:
CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import host_array, resolve_device

__all__ = ["save_sdf", "load_sdf", "read_sdf_vol_file", "save_trajectory",
           "load_trajectory"]


def save_sdf(path: str, sdf) -> None:
    """Save a PlanarSDF or SignedDistanceField to an .npz archive (replaces
    saveSDF, gpmp2.h:454-455 / SaveSDFExample.m); a packed table is not
    saved (`pack_sdf` rebuilds it)."""
    from ..obstacle.sdf import PlanarSDF

    kind = "planar" if isinstance(sdf, PlanarSDF) else "3d"
    np.savez_compressed(path, kind=kind, origin=host_array(sdf.origin),
                        cell_size=host_array(sdf.cell_size), data=host_array(sdf.data))


def load_sdf(path: str, dtype=torch.float32, device=None):
    """Load an .npz SDF saved by save_sdf (either package's)."""
    from ..obstacle.sdf import PlanarSDF, SignedDistanceField

    f = lambda x: torch.as_tensor(x, dtype=dtype, device=resolve_device(device))  # noqa: E731
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        origin, cell, data = f(z["origin"]), f(z["cell_size"]), f(z["data"])
    cls = PlanarSDF if kind == "planar" else SignedDistanceField
    return cls(origin=origin, cell_size=cell, data=data)


def read_sdf_vol_file(filename_pre: str, dtype=torch.float32, device=None) -> SignedDistanceField:
    """Read the reference's `.vol.head` / `.vol.data` pair
    (fileUtils.cpp:16-60): the head holds cols rows z, the origin and the
    resolution; the data is doubles filling x, then y, then z, innermost
    last, i.e. an (X, Y, Z) array, stored here as (Z, Y, X)."""
    from ..obstacle.sdf import SignedDistanceField

    with open(filename_pre + ".vol.head") as fh:
        tokens = fh.read().split()
    cols, rows, nz = int(tokens[0]), int(tokens[1]), int(tokens[2])
    origin = np.asarray([float(tokens[3]), float(tokens[4]), float(tokens[5])])
    res = float(tokens[6])
    data_flat = np.loadtxt(filename_pre + ".vol.data").reshape(-1)
    if data_flat.size != cols * rows * nz:
        raise ValueError("vol data size mismatch")
    data_zyx = np.transpose(data_flat.reshape(cols, rows, nz), (2, 1, 0))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=resolve_device(device))  # noqa: E731
    return SignedDistanceField(origin=f(origin), cell_size=f(res),
                               data=f(np.ascontiguousarray(data_zyx)))


def save_trajectory(path: str, traj: Trajectory) -> None:
    """Checkpoint a (possibly batched) trajectory."""
    np.savez_compressed(path, pose=host_array(traj.pose), vel=host_array(traj.vel))


def load_trajectory(path: str, dtype=torch.float32, device=None) -> Trajectory:
    from ..planner.problem import Trajectory

    f = lambda x: torch.as_tensor(x, dtype=dtype, device=resolve_device(device))  # noqa: E731
    with np.load(path, allow_pickle=False) as z:
        return Trajectory(f(z["pose"]), f(z["vel"]))

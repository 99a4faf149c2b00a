"""Device-mesh scale-out for batched planning on torch.distributed.

Port of gpmp2_tpu/parallel/mesh.py. JAX drives every device of a mesh
from one controller; PyTorch runs one process per device. So here a mesh
is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group (NCCL on CUDA, gloo on the CPU), each process holds
its own lanes of the problem batch (`shard_problems`), plans them with
`plan_batch`, and fleet-wide reductions are collectives over a mesh dim
(`fleet_stats`: one all_reduce of five sums, nothing gathered to a host).
Planning problems are independent, so a 'dp' mesh needs no other
communication. The trajectory-axis solve (OptimizerParams.ts_mesh,
solver/partitioned.py) shards each problem's segments over a 'ts' dim.

Typical use, in each process:
    mesh = make_mesh()                       # one rank per device on 'dp'
    probs, traj = shard_problems(mesh, probs, traj)
    res = plan_batch(probs, traj, params)
    stats = fleet_stats(mesh, res)
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

if TYPE_CHECKING:  # DeviceMesh and DTensor load when a mesh is made, not on import
    from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "shard_problems", "replicate", "batch_sharding", "fleet_stats"]


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None, device=None) -> DeviceMesh:
    """A DeviceMesh over every rank of the default process group, with
    named dims. Default: all ranks on a single 'dp' dim.

    Multi-dim example (trajectory-axis sharding):
        make_mesh(shape=(4, 2), axis_names=('dp', 'ts'))

    `device` None means CUDA with NCCL (raises without a card or NCCL);
    "cpu" means gloo. Without a process group this opens a one-process
    group on an in-memory store, so one device needs no launcher; with
    several processes, each calls `torch.distributed.init_process_group`
    first. `n_devices`, where given, must equal the world size."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("make_mesh: a CUDA mesh needs a CUDA device and NCCL")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"make_mesh: no backend for device {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend not in dist.get_backend():
        raise ValueError(f"make_mesh: the process group's backend is "
                         f"{dist.get_backend()!r}, a {dev.type} mesh needs {backend!r}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the process group has "
                         f"{world} ranks")
    shape = (world,) if shape is None else tuple(shape)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"make_mesh: shape {shape} with axes {tuple(axis_names)} does not "
                         f"cover {world} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh: DeviceMesh, axis: str = "dp"):
    """DTensor placements that split the leading (problem) axis over `axis`
    and replicate over the mesh's other dims."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicate(mesh: DeviceMesh):
    """DTensor placements that replicate over every dim of the mesh."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _dim(mesh: DeviceMesh, axis: str):
    """(size, this rank's coordinate) of the mesh dim `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


def shard_problems(mesh: DeviceMesh, problems, traj, axis: str = "dp"):
    """This rank's share of a problem batch: its contiguous block of lanes
    along the mesh dim `axis`, i.e. the rows of every per-lane field
    (`TrajProblem.lanes`, planner/problem.py::LANE_FIELDS; per-problem SDF
    worlds included) and of `traj`. Shared fields stay whole. The batch
    axis is explicit in the port's problems, so JAX's `problem_axes`
    argument is dropped, as `infer_batch_axes` is. Raises when the dim's
    size does not divide the batch."""
    size, rank = _dim(mesh, axis)
    B = traj.pose.shape[0]
    if B % size:
        raise ValueError(f"shard_problems: a batch of {B} does not split over mesh axis "
                         f"'{axis}' of size {size}")
    share = B // size
    idx = torch.arange(rank * share, (rank + 1) * share, device=traj.pose.device)
    return problems.lanes(idx), type(traj)(traj.pose[idx], traj.vel[idx])


def fleet_stats(mesh: DeviceMesh, result, axis: str = "dp"):
    """Fleet-wide statistics of an OptResult sharded over `axis`: each rank
    sums its lanes, then one all_reduce over the dim's group. Returns a
    dict of device scalars, the same on every rank:
      n, converged, gave_up, mean_error, mean_iters."""
    err = result.error
    local = torch.stack([
        result.converged.to(err.dtype).sum(),
        result.gave_up.to(err.dtype).sum(),
        err.sum(),
        result.iterations.to(err.dtype).sum(),
        torch.tensor(float(err.shape[0]), dtype=err.dtype, device=err.device),
    ])
    dist.all_reduce(local, group=mesh.get_group(axis))
    n = local[4]
    return {"n": n, "converged": local[0], "gave_up": local[1],
            "mean_error": local[2] / n, "mean_iters": local[3] / n}


def any_over_mesh(mesh: DeviceMesh, flag: torch.Tensor) -> bool:
    """Whether `flag` (a bool scalar tensor) is true on any rank of the
    whole mesh: one all_reduce. The optimizer's stop test under a ts mesh,
    so that every rank runs the same number of attempts (and collectives).
    The mesh must span the default group, as make_mesh's meshes do."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("any_over_mesh: the mesh does not span the process group")
    x = flag.to(torch.int32).reshape(1)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x)

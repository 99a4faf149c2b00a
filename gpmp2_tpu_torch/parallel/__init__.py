"""Device-mesh scale-out on torch.distributed (port of gpmp2_tpu/parallel)."""

from .mesh import batch_sharding, fleet_stats, make_mesh, replicate, shard_problems

__all__ = ["make_mesh", "shard_problems", "batch_sharding", "replicate", "fleet_stats"]

"""Data parallelism of the port: one process a device under
torch.distributed (the JAX package's parallel/)."""

from .distributed import host_batch_slice, maybe_initialize
from .mesh import (BatchShard, Mesh, all_reduce_grads, local_device_count,
                   make_mesh, replicate, shard_batch)

__all__ = ["make_mesh", "shard_batch", "replicate", "all_reduce_grads",
           "local_device_count", "Mesh", "BatchShard", "maybe_initialize",
           "host_batch_slice"]

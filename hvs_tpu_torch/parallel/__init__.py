"""Data parallelism over ``torch.distributed`` (counterpart of
``hvs_tpu/parallel``): process-group init, the mesh (``setup`` does both for
an entry point), batch sharding and the parameter sharding rules."""

from .mesh import (DEFAULT_PARAM_RULES, Mesh, PartitionSpec, initialize_distributed,
                   make_mesh, param_sharding, setup, shard_batch, sharded_fraction)

__all__ = ["DEFAULT_PARAM_RULES", "Mesh", "PartitionSpec", "initialize_distributed",
           "make_mesh", "param_sharding", "setup", "shard_batch", "sharded_fraction"]

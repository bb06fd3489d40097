"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``hvs_tpu/parallel``): process-group init, the ``(data x model)`` mesh
(``setup`` does both for an entry point), batch sharding, the parameter
sharding rules, and their execution over the model axis (``tensor``)."""

from .mesh import (DEFAULT_PARAM_RULES, Mesh, PartitionSpec, initialize_distributed,
                   make_mesh, param_sharding, setup, shard_batch, sharded_fraction)
from .tensor import (gather_parameters, gather_tensors, held_fraction, shard_parameters,
                     shard_tensors, sharded_dims)

__all__ = ["DEFAULT_PARAM_RULES", "Mesh", "PartitionSpec", "gather_parameters",
           "gather_tensors", "held_fraction", "initialize_distributed", "make_mesh",
           "param_sharding", "setup", "shard_batch", "shard_parameters", "shard_tensors",
           "sharded_dims", "sharded_fraction"]

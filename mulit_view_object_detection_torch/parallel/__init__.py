"""Data parallelism over processes (`distributed.py`) and the device
mesh: view sharding and tensor parallelism over (data, view, model)
process groups (`mesh.py`)."""

from .distributed import (all_reduce_gradients, all_reduce_sum,
                          broadcast_module, data_parallel_group,
                          host_local_batch_slice, init_distributed,
                          local_device)
from .mesh import (Mesh, Sharding, as_mesh, batch_sharding, gather_shards,
                   globalize_batch, make_mesh, make_parallel_train_step,
                   param_spec, replicate_state, replicated, shard_batch,
                   shard_params, shard_state_tp)

__all__ = ["Mesh", "Sharding", "all_reduce_gradients", "all_reduce_sum",
           "as_mesh", "batch_sharding", "broadcast_module",
           "data_parallel_group", "gather_shards", "globalize_batch",
           "host_local_batch_slice", "init_distributed", "local_device",
           "make_mesh", "make_parallel_train_step", "param_spec",
           "replicate_state", "replicated", "shard_batch", "shard_params",
           "shard_state_tp"]

"""Data parallelism over processes (`distributed.py`)."""

from .distributed import (all_reduce_gradients, all_reduce_sum,
                          broadcast_module, data_parallel_group,
                          host_local_batch_slice, init_distributed,
                          local_device)

__all__ = ["all_reduce_gradients", "all_reduce_sum", "broadcast_module",
           "data_parallel_group", "host_local_batch_slice",
           "init_distributed", "local_device"]

"""Multi-GPU: the (data, model) mesh of ranks, its process groups and the
sharding rules (counterpart of ``tfswa_tpu/parallel/``).  One rank is one
process on one card; the JAX package's ``analyze_jitted`` and
``compiled_flops`` are :func:`analyze` and ``utils.profiling.flops_of``
here, and ``shard_variables`` is :func:`shard_model`."""
from .analysis import (CollectiveStats, analyze, collective_stats, largest_tensor_bytes,
                       ring_all_reduce_link_bytes)
from .distributed import initialize_distributed, make_global_batch, process_info, rank_device
from .mesh import Axis, Mesh, create_mesh, mesh_from_config
from .sharding import (batch_sharding, gather_state_dict, load_whole_state_dict, param_spec,
                       replicated, shard_batch, shard_model, variables_shardings)

__all__ = [
    "Axis", "CollectiveStats", "Mesh", "analyze", "batch_sharding", "collective_stats",
    "create_mesh", "gather_state_dict", "initialize_distributed", "largest_tensor_bytes",
    "load_whole_state_dict", "make_global_batch", "mesh_from_config", "param_spec",
    "process_info", "rank_device", "replicated", "ring_all_reduce_link_bytes",
    "shard_batch", "shard_model", "variables_shardings",
]

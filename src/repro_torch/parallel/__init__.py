"""repro_torch.parallel — the sharding rules as DTensor placements, the
activation context (the mesh or the process groups the model's
collectives use) and the int8 compressed tensor-parallel reduction."""

from .actctx import activation_context, constrain, one_rank_group
from .compressed import rowparallel_einsum_compressed
from .sharding import (NamedSharding, ParallelismConfig, PartitionSpec,
                       abstract_mesh, batch_shardings, cache_shardings,
                       logical_to_pspec, opt_shardings, param_shardings,
                       placements)

__all__ = ["activation_context", "constrain", "one_rank_group",
           "rowparallel_einsum_compressed", "NamedSharding",
           "ParallelismConfig", "PartitionSpec", "abstract_mesh",
           "batch_shardings", "cache_shardings", "logical_to_pspec",
           "opt_shardings", "param_shardings", "placements"]

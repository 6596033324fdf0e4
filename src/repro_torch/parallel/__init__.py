"""repro_torch.parallel — the activation context (which process groups
the model's collectives use) and the int8 compressed tensor-parallel
reduction.  Sharding rules and DTensor placements arrive with ROADMAP A7."""

from .actctx import activation_context, constrain, one_rank_group
from .compressed import rowparallel_einsum_compressed

__all__ = ["activation_context", "constrain", "one_rank_group",
           "rowparallel_einsum_compressed"]

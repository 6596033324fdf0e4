"""repro_torch.checkpoint — basket-format checkpoints of torch tensors,
preconditioned on the GPU, with the reference's container bytes."""

from .manager import (CheckpointManager, load_pytree, save_pytree,
                      tree_from_numpy)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "tree_from_numpy"]

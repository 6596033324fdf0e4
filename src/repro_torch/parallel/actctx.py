"""Activation context: the process groups that model code reduces over.

The reference's context holds a JAX mesh and names its TP axis
(``repro/parallel/actctx.py``); here it holds ``torch.distributed``
process groups: ``tp`` for the tensor-parallel collectives, ``dp`` for the
data-parallel axis (``None``: one replica).  Model code reads it through
``_CTX``.  ``constrain`` keeps the reference's call sites and is a no-op:
DTensor placements arrive with ROADMAP A7.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["set_activation_context", "clear_activation_context", "constrain",
           "activation_context", "one_rank_group"]

_CTX: dict = {"tp": None, "dp": None}


def set_activation_context(tp, dp=None) -> None:
    _CTX.update(tp=tp, dp=dp)


def clear_activation_context() -> None:
    _CTX.update(tp=None, dp=None)


class activation_context:
    def __init__(self, tp, dp=None):
        self.tp, self.dp = tp, dp

    def __enter__(self):
        set_activation_context(self.tp, self.dp)

    def __exit__(self, *a):
        clear_activation_context()


def constrain(x, kinds):
    """Placement hint ('dp' | 'tp' | None per dim); a no-op in the port."""
    return x


def one_rank_group(backend: str):
    """The default process group of a world of one rank (``"nccl"`` on the
    card, ``"gloo"`` on the CPU), made in-process with no network: a
    ``HashStore`` is the rendezvous.  Reused if this process already has
    one; raises if that one differs."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = (dist.get_backend(), dist.get_world_size())
    if have != (backend, 1):
        raise RuntimeError(f"one_rank_group: the default process group is "
                           f"{have[0]} over {have[1]} ranks, not {backend} "
                           "over 1")
    return dist.group.WORLD

"""repro_torch.tune — measurement-driven compression autotuning (DESIGN.md §11).

The paper's survey as an online subsystem: sample real branch payloads,
run trial compressions through the codec/preconditioner registries, fit a
per-branch (ratio, write MB/s, read MB/s) cost model, and pick the
Pareto-optimal config under a declared objective.  Decisions cache per
branch, persist in the BasketFile TOC, and are guarded by a cheap
ratio/entropy drift detector.

Entry points: ``Tuner`` (the subsystem), ``OBJECTIVES`` (the operating
points), and the ``tuner=``/``objective=`` arguments on ``BasketWriter``,
``save_pytree``/``CheckpointManager``, and ``write_token_shards``.
``repro_torch.core.policy.choose`` remains the zero-measurement fallback.
"""

from .model import (OBJECTIVES, Objective, TrialResult, pareto_front,
                    resolve_objective, select)
from .sampler import byte_entropy, sample_offsets, stratified_sample
from .tuner import Decision, Tuner, default_candidates, load_decisions

__all__ = [
    "OBJECTIVES", "Objective", "TrialResult", "pareto_front",
    "resolve_objective", "select",
    "byte_entropy", "sample_offsets", "stratified_sample",
    "Decision", "Tuner", "default_candidates", "load_decisions",
]

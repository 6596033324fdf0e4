"""repro_torch.train — AdamW written from the reference's formulas, the
mixed-precision train step with gradient accumulation, clipping, the LR
schedule and the compressed-gradient hook (the port of ``repro.train``)."""

from .optim import adamw_init, adamw_update, clip_by_global_norm, warmup_cosine
from .step import (TrainState, make_train_step, init_train_state,
                   abstract_train_state)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "warmup_cosine", "TrainState", "make_train_step",
           "init_train_state", "abstract_train_state"]

"""repro_torch.serve — batched serving: slot-based continuous batching over
a model's prefill/decode steps."""

from .engine import ServeEngine, sample_logits

__all__ = ["ServeEngine", "sample_logits"]

"""repro_torch.data — the paper's NanoAOD-like event tree and the LM token
pipeline over BasketFiles."""

from .events import make_events, write_event_file, EVENT_BRANCHES
from .pipeline import TokenPipeline, write_token_shards

__all__ = ["make_events", "write_event_file", "EVENT_BRANCHES",
           "TokenPipeline", "write_token_shards"]

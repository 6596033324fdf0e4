"""repro_torch.data — the paper's NanoAOD-like event tree."""

from .events import make_events, write_event_file, EVENT_BRANCHES

__all__ = ["make_events", "write_event_file", "EVENT_BRANCHES"]

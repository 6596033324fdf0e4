"""Trace-context propagation: W3C-traceparent-style causal identity.

A :class:`SpanContext` is the portable identity of one span — a 16-byte
``trace_id`` shared by every span in one causal tree, an 8-byte
``span_id`` naming this span, and a flags byte (bit 0 = sampled).  It
serializes to the W3C ``traceparent`` layout::

    00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01
    ^  trace_id (32 hex)                 span_id (16 hex)  ^flags

which is what crosses process boundaries: RBSP request bodies carry it
as the ``"tp"`` key (DESIGN.md §16), the engine's pool tasks carry it as
a trailing argument, and a server/worker *activates* the parsed context
so its own spans become children of the remote caller's span.

This module owns only identity and the thread-local activation stack —
no event recording (that is :mod:`repro_torch.obs.trace`) and no metrics
(:mod:`repro_torch.obs.metrics` reads :func:`current` for histogram
exemplars).  Both import this; this imports neither.

Id generation uses a module-level :class:`random.Random` seeded from
``os.urandom`` — ids need uniqueness, not unpredictability, and
``getrandbits`` is ~20x cheaper than an ``os.urandom`` syscall per span.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional

__all__ = [
    "SpanContext", "current", "current_traceparent", "push", "pop",
    "activated", "new_trace_id", "new_span_id", "from_traceparent",
]

_rng = random.Random(os.urandom(16))
_rng_lock = threading.Lock()


class _TLS(threading.local):
    """Per-thread activation stack.  The subclass ``__init__`` runs on a
    thread's first access, so ``_tls.stack`` is always a plain attribute
    read — ``getattr(local(), "stack", None)`` on an unset slot raises
    and catches AttributeError internally, ~5x the cost, and the unset
    case is the hot one (every untraced observe/span probes it)."""

    def __init__(self):
        self.stack = []


_tls = _TLS()


def new_trace_id() -> str:
    with _rng_lock:
        return f"{_rng.getrandbits(128):032x}"


def new_span_id() -> str:
    with _rng_lock:
        return f"{_rng.getrandbits(64):016x}"


class SpanContext:
    """One span's identity (immutable value object)."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def child(self) -> "SpanContext":
        """A fresh span id under the same trace."""
        return SpanContext(self.trace_id, new_span_id(), self.flags)

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpanContext({self.to_traceparent()})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, SpanContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.flags == other.flags)


def from_traceparent(tp) -> Optional[SpanContext]:
    """Parse a traceparent string; None for anything malformed (a remote
    peer's bad header must never fail the request it rode in on)."""
    if not isinstance(tp, str):
        return None
    parts = tp.split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, span_id, flags = parts
    if len(ver) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        fl = int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, fl)


def current() -> Optional[SpanContext]:
    """The active span context on this thread, or None."""
    s = _tls.stack
    return s[-1] if s else None


def current_traceparent() -> Optional[str]:
    ctx = current()
    return ctx.to_traceparent() if ctx is not None else None


def push(ctx: SpanContext) -> None:
    _tls.stack.append(ctx)


def pop() -> Optional[SpanContext]:
    s = _tls.stack
    return s.pop() if s else None


class _Activation:
    __slots__ = ("_ctx",)

    def __init__(self, ctx: Optional[SpanContext]):
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            push(self._ctx)
        return self._ctx

    def __exit__(self, *a):
        if self._ctx is not None:
            pop()


def activated(ctx) -> _Activation:
    """Context manager making ``ctx`` the ambient parent for the block —
    the adoption point for a remote caller's traceparent.  ``ctx`` may be
    a :class:`SpanContext`, a traceparent string, or None (no-op), so
    callers can pass a request body's ``"tp"`` value straight in."""
    if isinstance(ctx, str):
        ctx = from_traceparent(ctx)
    return _Activation(ctx)

"""Typed failure taxonomy for the remote tier (DESIGN.md §14).

Every way a remote read can fail maps onto exactly one class here, and
every class answers two questions: *is it safe to retry* and *is the
connection still usable*.  The retry loop in ``remote.client`` switches
on these — a connect refusal, a dead-peer timeout, and a garbled frame
are all retried against the :class:`EndpointPool` (reads are idempotent),
while an application error from the server (missing branch, stale
generation, bad path) surfaces immediately: retrying it would return the
same answer and hide a real bug.

The taxonomy double-inherits from the builtin exception the old code
raised (``TimeoutError``, ``ConnectionError``, ``RuntimeError``) so
callers written against the first remote API — ``except RuntimeError`` around a fetch,
``pytest.raises(RuntimeError, match="stale generation")`` — keep
working unchanged.
"""

from __future__ import annotations

from . import protocol as P

__all__ = [
    "RemoteError", "RemoteTimeout", "RemoteConnectError",
    "RemoteServerError", "StaleGenerationError", "ServerBusy",
    "ReplicaMismatchError", "RepairFailedError", "classify_error",
    "RETRYABLE",
]


class RemoteError(Exception):
    """Base class for every remote-tier failure."""


class RemoteTimeout(RemoteError, TimeoutError):
    """A connect/send/recv exceeded its deadline (dead or stalled peer)."""


class RemoteConnectError(RemoteError, ConnectionError):
    """TCP connect to an endpoint failed (refused, unreachable, reset)."""


class RemoteServerError(RemoteError, RuntimeError):
    """The server answered ``RESP_ERROR`` — an application-level failure
    (bad path, unknown branch, out-of-range basket).  Not retried: the
    request itself is wrong, not the transport."""


class StaleGenerationError(RemoteServerError):
    """The served file was atomically replaced since the catalog was
    fetched; the caller must re-open to get the new TOC."""


class ServerBusy(RemoteError):
    """The server shed this request (``RESP_BUSY``).  Carries the
    server's suggested ``retry_after`` in seconds; the client retry loop
    honours it instead of its own backoff schedule."""

    def __init__(self, msg: str = "server busy", retry_after: float = 0.05):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class ReplicaMismatchError(RemoteError):
    """A failover/hedge endpoint serves a *different* file under the same
    path (branch set or basket checksums disagree with the catalog this
    reader opened).  The endpoint is quarantined — silently mixing
    replicas with divergent content is the one thing a failover layer
    must never do."""


class RepairFailedError(RemoteError):
    """A repair pass (scrub heal, anti-entropy reconcile, ``bscrub``)
    finished with damage it could not fix — every parity stripe and every
    replica was tried.  Carries the surviving ``(branch, index)`` list so
    the operator knows exactly which bytes the fleet has lost."""

    def __init__(self, msg: str, remaining=()):
        super().__init__(msg)
        self.remaining = [tuple(r) for r in remaining]


def classify_error(exc: BaseException) -> str:
    """Map a transport failure onto its retry-reason label — the value
    of the ``reason`` tag on ``remote.retries`` counters."""
    if isinstance(exc, ServerBusy):
        return "busy"
    if isinstance(exc, RemoteTimeout):
        return "timeout"
    if isinstance(exc, RemoteConnectError):
        return "connect"
    if isinstance(exc, ReplicaMismatchError):
        return "mismatch"
    if isinstance(exc, P.ProtocolError):
        return "frame"
    if isinstance(exc, (ConnectionResetError, BrokenPipeError)):
        return "reset"
    if isinstance(exc, EOFError):
        return "reset"
    if isinstance(exc, OSError):
        return "io"
    return "other"


# transport-level failures the client retries against the pool; server
# application errors (RemoteServerError) are deliberately absent
RETRYABLE = (RemoteTimeout, RemoteConnectError, ReplicaMismatchError,
             P.ProtocolError, ServerBusy, EOFError, OSError)

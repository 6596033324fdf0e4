"""repro_torch.remote — the basket-granular content service (DESIGN.md §12).

The distribution layer over the local stack: an xrootd-analogue server
exports directories of BasketFiles and answers *vectored* basket requests
coalesced into large sequential preads; clients mirror the ``BasketFile``
read API over the wire with readahead, per-request wire transcoding
(archive codecs re-encoded decode-cheap for read-bound objectives), and a
tiered decoded/wire cache keyed by the file's (st_dev, st_ino) generation.

Entry points:

* :class:`BasketServer` — serve a directory (``python -m repro_torch.remote`` /
  ``tools/bserve.py`` are the CLI);
* :class:`RemoteBasketFile` / :func:`connect` — open a
  ``repro://host:port/path`` URL with the local reader API;
* :class:`TieredCache` — the client cache, shareable across files;
* :class:`EndpointPool` — replica endpoints with health tracking, shared
  across files for failover and hedged reads;
* ``repro_torch.data.pipeline.TokenPipeline`` accepts ``repro://`` shard URLs
  directly, and :class:`repro_torch.io.prefetch.PrefetchReader` accepts a
  ``RemoteBasketFile`` wherever a local ``BasketFile`` goes.

Failure semantics (DESIGN.md §14) live in :mod:`repro_torch.remote.errors`:
typed timeouts/connect errors, ``ServerBusy`` shedding, replica mismatch,
and the retry classification the client's backoff policy keys on.
"""

from .cache import TieredCache, basket_key
from .client import (EndpointPool, RemoteBasketFile, connect, fetch_catalog,
                     request_scrub)
from .errors import (RemoteConnectError, RemoteError, RemoteServerError,
                     RemoteTimeout, RepairFailedError, ReplicaMismatchError,
                     ServerBusy, StaleGenerationError)
from .protocol import ProtocolError, coalesce, format_url, parse_url
from .server import BasketServer

__all__ = [
    "BasketServer", "RemoteBasketFile", "connect", "fetch_catalog",
    "request_scrub", "TieredCache",
    "basket_key", "EndpointPool", "ProtocolError", "coalesce", "parse_url",
    "format_url", "RemoteError", "RemoteTimeout", "RemoteConnectError",
    "RemoteServerError", "StaleGenerationError", "ServerBusy",
    "ReplicaMismatchError", "RepairFailedError",
]

"""RBSP — the repro basket-service wire protocol (DESIGN.md §12).

The xrootd analogue's framing layer: length-prefixed frames carrying a
canonical-JSON body plus an optional binary payload, shared verbatim by
client and server.  Every payload carries a frame-level adler32 so a
truncated or corrupted wire fails at the frame boundary — *before* any
basket metadata is trusted — and every basket inside the payload still
carries its own raw-byte checksum from the container, so content integrity
is verified end-to-end even across wire transcoding.

Frame layout (little-endian)::

    [4B magic "RBP1"][1B type][4B body_len][8B payload_len]
    [4B adler32(payload)][body_len JSON bytes][payload_len bytes]

The JSON body is canonical (sorted keys, no whitespace) so a given request
or response has exactly one byte encoding — the property the golden
wire-frame test pins so the protocol cannot drift silently.

Frame types::

    REQ_CATALOG   {"path"}                               -> RESP_CATALOG
    REQ_READV     {"path", "generation", "baskets":      -> RESP_READV
                   [[branch, index], ...], "wire": null
                   | {"objective", "accept"}}
    REQ_PING      {}                                     -> RESP_PING
    REQ_STATS     {} | {"trace": true}                   -> RESP_STATS
    REQ_SCRUB     {"action": "status"}                   -> RESP_SCRUB
                  | {"action": "trigger"}
                  | {"action": "scrub", "path"?}
    REQ_PROF      {"action": "status"}                   -> RESP_PROF
                  | {"action": "start", "hz"?, "mem"?}
                  | {"action": "stop"}
                  | {"action": "fetch", "reset"?}
    RESP_ERROR    {"error"}   (any request may answer this)
    RESP_BUSY     {"error": "busy", "retry_after_s"}
                  (load shedding: the server's admission queue is
                  saturated; retry after the suggested delay)

``REQ_STATS`` is the observability verb (DESIGN.md §13): the server
answers with a generation-stamped canonical-JSON snapshot of its obs
registry plus the per-server ``stats`` dict — no path required, so a
monitor can point at a bare host:port.  ``"trace": true`` additionally
drains the server's span ring into ``"trace_events"``.

``REQ_PROF`` is the continuous-profiling control verb (DESIGN.md §17):
``start``/``stop`` manage the server's sampling profiler (``hz`` sets
the sample rate, ``mem`` arms memory watermarks), ``status`` reports it,
and ``fetch`` ships the collapsed-stack fold table (``reset: true``
drains it, so successive fetches cover disjoint windows) — the
``obstat --prof`` flamegraph capture path.

``REQ_SCRUB`` is the self-healing control verb (DESIGN.md §15):
``status`` snapshots the server's background scrubber, ``trigger`` wakes
it for an immediate sweep, and ``scrub`` runs one synchronous scrub of a
single container (or the whole export root) on the request thread —
the operator's "prove it is clean *now*" hook (``tools/bscrub.py``).

``REQ_READV`` is the vectored read: many (branch, basket) ranges per
round-trip.  The server coalesces them into large sequential ``pread``s
(:func:`coalesce`) and answers with one payload holding the concatenated
basket payloads plus per-basket metadata (possibly transcoded for the
wire) in the body.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

from repro_torch.core.checksum import adler32_hw

__all__ = [
    "MAGIC", "ProtocolError",
    "REQ_CATALOG", "REQ_READV", "REQ_PING", "REQ_STATS", "REQ_SCRUB",
    "REQ_PROF",
    "RESP_CATALOG", "RESP_READV", "RESP_PING", "RESP_STATS", "RESP_SCRUB",
    "RESP_PROF", "RESP_BUSY", "RESP_ERROR",
    "VERB_NAMES",
    "pack_frame", "read_frame", "recv_exact",
    "coalesce", "parse_url", "format_url",
]

MAGIC = b"RBP1"
_HEADER = struct.Struct("<4sBIQI")       # magic, type, body_len, payload_len, payload_sum

# request types
REQ_CATALOG = 1
REQ_READV = 2
REQ_PING = 3
REQ_STATS = 4
REQ_SCRUB = 5
REQ_PROF = 6
# response types
RESP_CATALOG = 16
RESP_READV = 17
RESP_PING = 18
RESP_STATS = 19
RESP_SCRUB = 20
RESP_PROF = 21
RESP_BUSY = 30
RESP_ERROR = 31

_TYPES = {REQ_CATALOG, REQ_READV, REQ_PING, REQ_STATS, REQ_SCRUB, REQ_PROF,
          RESP_CATALOG, RESP_READV, RESP_PING, RESP_STATS, RESP_SCRUB,
          RESP_PROF, RESP_BUSY, RESP_ERROR}

# human-readable verb names for metric labels and error log lines
VERB_NAMES = {REQ_CATALOG: "catalog", REQ_READV: "readv",
              REQ_PING: "ping", REQ_STATS: "stats", REQ_SCRUB: "scrub",
              REQ_PROF: "prof"}

# sanity bounds: a malformed header must fail fast, not allocate gigabytes
MAX_BODY = 64 << 20
MAX_PAYLOAD = 4 << 30


class ProtocolError(ValueError):
    """Malformed, truncated, or corrupted wire frame."""


def pack_frame(ftype: int, body: dict, payload: bytes = b"") -> bytes:
    """Encode one frame.  The body is canonical JSON (sorted keys, compact
    separators) so identical logical frames are identical bytes."""
    if ftype not in _TYPES:
        raise ProtocolError(f"unknown frame type {ftype}")
    bj = json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    head = _HEADER.pack(MAGIC, ftype, len(bj), len(payload),
                        adler32_hw(payload))
    return head + bj + bytes(payload)


def recv_exact(rfile, n: int) -> bytes:
    """Read exactly ``n`` bytes from a file-like socket reader; raises
    :class:`ProtocolError` on a short read (peer vanished mid-frame)."""
    chunks = []
    got = 0
    while got < n:
        b = rfile.read(n - got)
        if not b:
            raise ProtocolError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(b)
        got += len(b)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def read_frame(rfile) -> tuple[int, dict, bytes]:
    """Read one frame; returns ``(type, body, payload)``.

    Raises :class:`ProtocolError` for bad magic, unknown type, oversized
    lengths, truncation, undecodable body, or payload checksum mismatch —
    and ``EOFError`` for a clean end-of-stream (no bytes at all)."""
    head = rfile.read(_HEADER.size)
    if not head:
        raise EOFError("end of stream")
    while len(head) < _HEADER.size:
        # unbuffered readers (the hedging client's raw SocketIO) may
        # return a partial header on a segment boundary; loop, and treat
        # EOF mid-header as the truncation it is
        more = rfile.read(_HEADER.size - len(head))
        if not more:
            raise ProtocolError(f"truncated header ({len(head)} bytes)")
        head += more
    magic, ftype, body_len, payload_len, payload_sum = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if ftype not in _TYPES:
        raise ProtocolError(f"unknown frame type {ftype}")
    if body_len > MAX_BODY or payload_len > MAX_PAYLOAD:
        raise ProtocolError(
            f"frame too large (body {body_len}, payload {payload_len})")
    try:
        body = json.loads(recv_exact(rfile, body_len)) if body_len else {}
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"undecodable frame body: {e}") from None
    if not isinstance(body, dict):
        raise ProtocolError("frame body must be a JSON object")
    payload = recv_exact(rfile, payload_len) if payload_len else b""
    if adler32_hw(payload) != payload_sum:
        raise ProtocolError("payload checksum mismatch (corrupt frame)")
    return ftype, body, payload


# ---------------------------------------------------------------------------
# request coalescing
# ---------------------------------------------------------------------------

def coalesce(ranges, max_gap: int = 64 << 10,
             max_span: int = 8 << 20) -> list[tuple[int, int, list[int]]]:
    """Merge byte ranges into large sequential reads.

    ``ranges`` is a sequence of ``(offset, length)``; returns
    ``[(offset, length, member_indices), ...]`` sorted by offset, where
    each merged read covers every member range.  Two ranges merge when the
    gap between them is ≤ ``max_gap`` (reading a small hole sequentially
    beats a second seek/syscall) and the merged span stays ≤ ``max_span``
    (bounding per-read buffer memory).  Members keep their index into the
    input sequence so the caller can slice each basket back out.
    """
    order = sorted(range(len(ranges)), key=lambda i: (ranges[i][0], ranges[i][1]))
    out: list[tuple[int, int, list[int]]] = []
    for i in order:
        off, ln = int(ranges[i][0]), int(ranges[i][1])
        if out:
            c_off, c_len, members = out[-1]
            end = c_off + c_len
            if off - end <= max_gap and max(end, off + ln) - c_off <= max_span:
                out[-1] = (c_off, max(end, off + ln) - c_off, members + [i])
                continue
        out.append((off, ln, [i]))
    return out


# ---------------------------------------------------------------------------
# repro:// URLs
# ---------------------------------------------------------------------------

def parse_url(url: str) -> tuple[str, int, str]:
    """``repro://host:port/rel/path.bskt`` -> ``(host, port, "rel/path.bskt")``."""
    if not url.startswith("repro://"):
        raise ValueError(f"not a repro:// URL: {url!r}")
    rest = url[len("repro://"):]
    hostport, sep, path = rest.partition("/")
    host, _, port = hostport.rpartition(":")
    if not host or not port or not sep or not path:
        raise ValueError(f"malformed repro:// URL: {url!r} "
                         "(want repro://host:port/path)")
    return host, int(port), path


def format_url(host: str, port: int, path: str) -> str:
    return f"repro://{host}:{port}/{path.lstrip('/')}"

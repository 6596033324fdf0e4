"""Wire transcoding: re-encode archive-tier baskets for read-bound clients.

The paper's online/offline split stores data at archive operating points
(lzma / high-level zstd: maximum ratio, slow decode) while analysis clients
are decode-throughput-bound.  A basket service can split the difference
per request: decode the archive codec *server-side* (once, amortized over
every client) and ship the basket re-encoded in a decode-cheap wire codec
(lz4 / zstd-fast / identity).

The mechanism reuses the whole existing stack:

* only the entropy codec is swapped — the preconditioner stage (shuffle /
  delta / bitshuffle) is preserved in the wire metadata, so the client's
  normal ``unpack_basket`` path (the vectorized cores, the
  decompress-into plane) decodes wire baskets with zero new code;
* the basket's raw-byte adler32 travels unchanged through the transcode
  (the raw bytes are the same), so the client's checksum verification is
  end-to-end: it would catch a server-side transcoding bug, not just wire
  corruption;
* whether transcoding *pays* is decided by a tuner :class:`Objective`
  blend over the client's **effective read rate** — a basket must cross
  the link (``comp_len`` bytes at ``link_mbps``) and then decode
  (``orig_len`` bytes at the codec's decode rate), so

      eff_rate = orig_len / (comp_len/link + orig_len/decode_rate)

  and the score is ``w_ratio·log(ratio) + w_read·log(eff_rate)`` with the
  *actual* transcoded sizes.  Ratio-bound objectives (``min_bytes``,
  ``production``) keep the archive bytes; read-bound ones (``analysis``,
  ``max_read_tput``) ship whichever wire codec wins the blend — identity
  on fast links (decode is the bottleneck), a real wire codec as the
  declared link gets slower (wire bytes start to dominate), the archive
  bytes again when its ratio advantage beats everything the link can
  save.
"""

from __future__ import annotations

import math
import time
from typing import Iterable, Optional, Sequence

from repro_torch import obs
from repro_torch.core import basket as _basket
from repro_torch.core import codec as _codec
from repro_torch.tune.model import Objective, resolve_objective

__all__ = ["WIRE_DECODE_MBPS", "WIRE_LEVELS", "wire_candidates",
           "score_wire", "transcode_basket", "transcode_many"]

# Nominal client-side decode throughput (MB/s) per codec — the decision
# rule's read-axis constants.  These are order-of-magnitude anchors from
# the fig_entropy / fig3 benchmark family (C codecs release the GIL and
# run at memory-ish speeds; the from-scratch vectorized cores are 1-2
# orders slower; lzma is the archive-tier outlier), not live measurements:
# the rule needs a stable *ranking*, and a served workload must not make
# per-request decisions from noisy one-shot timings.
WIRE_DECODE_MBPS: dict[str, float] = {
    "none": 8000.0,          # memcpy
    "zstd-fast": 900.0,      # libzstd, negative levels
    "zstd": 700.0,           # libzstd
    "zlib": 250.0,
    "lz4": 120.0,            # our vectorized two-pass token decoder
    "repro-zstd": 30.0,
    "repro-deflate": 25.0,
    "repro-deflate-ref": 25.0,
    "lzma": 60.0,
}
if not _codec.HAVE_ZSTD:
    # offline fallback: "zstd"/"zstd-fast" are backed by the pure-Python
    # large-window engine (DESIGN.md §4) — the decision rule must rank
    # what will actually run, not what the codec name suggests
    WIRE_DECODE_MBPS["zstd"] = WIRE_DECODE_MBPS["repro-zstd"]
    WIRE_DECODE_MBPS["zstd-fast"] = 40.0

# The link speed assumed when the request doesn't declare one (MB/s —
# ~10GbE).  Clients on slower links declare it per request; it shifts the
# effective-rate optimum from identity toward real wire codecs.
DEFAULT_LINK_MBPS = 1000.0

# The level each codec is *encoded at for the wire*: cheapest useful level
# — wire encoding happens per request, so encode cost is server latency.
WIRE_LEVELS: dict[str, int] = {
    "none": 0, "lz4": 1, "zstd-fast": 1, "zstd": 1, "zlib": 1,
}

DEFAULT_ACCEPT: tuple[str, ...] = ("zstd-fast", "lz4", "none")


def _rate(algo: str) -> float:
    return WIRE_DECODE_MBPS.get(algo, 50.0)


def effective_read_mbps(orig_len: int, comp_len: int, algo: str,
                        link_mbps: float = DEFAULT_LINK_MBPS) -> float:
    """Client-perceived MB/s of raw bytes for one basket: the wire bytes
    cross the link, then the raw bytes come out of the decoder — the two
    serial stages every remote read pays."""
    orig = max(int(orig_len), 1)
    t = max(int(comp_len), 1) / (max(link_mbps, 1e-6) * 1e6) \
        + orig / (_rate(algo) * 1e6)
    return orig / t / 1e6


def score_wire(objective: Objective, orig_len: int, comp_len: int,
               algo: str, link_mbps: float = DEFAULT_LINK_MBPS) -> float:
    """The objective's score for shipping this basket as ``comp_len``
    bytes of ``algo``: ratio axis from actual sizes, read axis from the
    effective (link + decode) rate.  (The write axis is server-side cost,
    not part of what the *client* optimizes — it is bounded by the
    prefilter.)"""
    ratio = orig_len / max(comp_len, 1)
    return (objective.w_ratio * math.log(max(ratio, 1e-9))
            + objective.w_read * math.log(
                effective_read_mbps(orig_len, comp_len, algo, link_mbps)))


def wire_candidates(meta_json: dict, objective, accept: Sequence[str],
                    link_mbps: float = DEFAULT_LINK_MBPS) -> list[str]:
    """Prefilter: which accepted wire codecs are worth *encoding* for this
    basket?  Transcoding is considered only when

    * the objective is read-bound (``w_read > w_ratio`` — a ratio-bound
      client asked for the archive bytes, don't burn server CPU), and
    * the candidate could beat the source's actual effective read rate
      even in the worst case for wire bytes (its compressed size unknown
      until encoded, so assume incompressible: ``stored_len`` on the
      wire).  A codec that loses *then* can never win after paying real
      encode work — e.g. re-encoding zstd-fast into the slower pure-Python
      lz4 is pruned before any CPU is spent.
    """
    obj = resolve_objective(objective)
    if obj.w_read <= obj.w_ratio:
        return []
    src = meta_json.get("algo", "none")
    if src == "none":
        return []                       # already the cheapest decode
    orig = int(meta_json["orig_len"])
    stored = int(meta_json["stored_len"])
    src_eff = effective_read_mbps(orig, int(meta_json["comp_len"]), src,
                                  link_mbps)
    return [a for a in accept
            if a in _codec.CODECS and a != src
            and effective_read_mbps(orig, stored, a, link_mbps) > src_eff]


def transcode_basket(payload, meta_json: dict,
                     dictionary: Optional[bytes], objective,
                     accept: Sequence[str] = DEFAULT_ACCEPT,
                     link_mbps: float = DEFAULT_LINK_MBPS
                     ) -> tuple[bytes, dict]:
    """Re-encode one basket payload for the wire if the objective says it
    pays; returns ``(wire_payload, wire_meta_json)`` — the input pair
    unchanged when keeping the archive bytes wins.

    Only the entropy-codec stage is swapped: the archive codec is decoded
    to the *preconditioned* byte stream (no precond inversion — that stays
    on the client, where the decode-into path fuses it with the
    destination scatter), then re-encoded with each candidate wire codec;
    the actually-measured sizes feed the objective score.  The raw-byte
    checksum and entry bookkeeping are copied through untouched.
    """
    cands = wire_candidates(meta_json, objective, accept, link_mbps)
    if not cands:
        obs.counter("transcode.decisions", wire="pruned").inc()
        return payload, meta_json
    t0 = time.perf_counter()
    obj = resolve_objective(objective)
    src = meta_json["algo"]
    orig_len = int(meta_json["orig_len"])
    stored_len = int(meta_json["stored_len"])
    d = dictionary if meta_json.get("has_dict") else None
    staged = _codec.get_codec(src).decompress(bytes(payload), stored_len, d)
    if len(staged) != stored_len:
        raise ValueError(
            f"transcode decode produced {len(staged)} bytes, "
            f"expected stored_len {stored_len}")
    best = (score_wire(obj, orig_len, int(meta_json["comp_len"]), src,
                       link_mbps),
            payload, meta_json)
    # identity first (free — `staged` is already in hand), then the real
    # codecs; before paying a candidate's encode, bound its best possible
    # score (ratio can't beat the archive's at wire levels, effective
    # rate can't beat its decode rate) — a candidate whose ceiling loses
    # to the standing best is skipped without encoding a byte
    src_ratio = max(orig_len / max(int(meta_json["comp_len"]), 1), 1.0)
    for algo in sorted(cands, key=lambda a: a != "none"):
        if algo != "none":
            ceiling = (obj.w_ratio * math.log(src_ratio)
                       + obj.w_read * math.log(_rate(algo)))
            if ceiling <= best[0]:
                continue
        level = WIRE_LEVELS.get(algo, 1)
        wp = _codec.get_codec(algo).compress(staged, level, None) \
            if algo != "none" else staged
        s = score_wire(obj, orig_len, len(wp), algo, link_mbps)
        if s > best[0]:
            wm = dict(meta_json)
            wm.update(algo=algo, level=level, comp_len=len(wp),
                      has_dict=False)
            best = (s, wp, wm)
    won = best[2]["algo"] if best[2] is not meta_json else "kept"
    obs.counter("transcode.decisions", wire=won).inc()
    obs.histogram("transcode.s", src=src).observe(time.perf_counter() - t0)
    return best[1], best[2]


def transcode_many(items: Iterable[tuple], objective,
                   accept: Sequence[str] = DEFAULT_ACCEPT,
                   engine=None,
                   link_mbps: float = DEFAULT_LINK_MBPS
                   ) -> list[tuple[bytes, dict]]:
    """Transcode a vectored request's baskets, in order.

    ``items`` yields ``(payload, meta_json, dictionary)``.  With an
    ``engine`` (the server's shared :class:`CompressionEngine`), baskets
    transcode concurrently on its thread pool — the C archive codecs
    (lzma/zstd/zlib) release the GIL while decoding, which is where the
    time goes."""
    items = list(items)
    if engine is not None and len(items) > 1:
        futs = [engine.submit(transcode_basket, p, m, d, objective, accept,
                              link_mbps)
                for p, m, d in items]
        return [f.result() for f in futs]
    return [transcode_basket(p, m, d, objective, accept, link_mbps)
            for p, m, d in items]


def verify_transcode(payload, meta_json: dict, wire_payload,
                     wire_meta: dict, dictionary=None) -> bool:
    """Debug/test helper: both payloads must decode to identical raw
    bytes (same checksum, same content)."""
    a = _basket.unpack_basket(bytes(payload),
                              _basket.BasketMeta.from_json(meta_json),
                              dictionary)
    b = _basket.unpack_basket(bytes(wire_payload),
                              _basket.BasketMeta.from_json(wire_meta),
                              dictionary if wire_meta.get("has_dict") else None)
    return a == b

"""From-scratch LZ77 + Huffman codec — the measurable CF-ZLIB / ZSTD testbed.

The paper attributes CF-ZLIB's fast-level speedup to three mechanisms
(§2.1); two of them are *algorithmic* and reproduced here so they can be
measured rather than cited:

* **Triplet vs quadruplet hashing.** Reference zlib hashes 3-byte windows
  (more collisions, longer chains); CF-ZLIB hashes 4-byte windows on levels
  1-5 and computes them with vector instructions.  ``mode="ref"`` uses
  3-byte hashes computed incrementally (scalar, zlib-style); ``mode="cf"``
  uses 4-byte hashes precomputed for the whole buffer in one vectorized
  numpy pass (the SIMD analogue).  ``benchmarks/fig45_cfzlib.py`` measures
  the wall-clock and match-quality difference.
* **The entropy stage.** Both modes finish with a canonical Huffman pass
  (``repro_torch.core.huffman``) over the token stream — ZLIB's second pass.

The same engine also hosts the **ZSTD mechanism ablation** (§2.3): ZSTD's
ratio win comes partly from a 256 KB window (8x zlib's 32 KB).  The
``window_log`` knob makes that single variable measurable:
``repro-deflate`` = 15 (32 KB, zlib-like); ``repro-zstd`` = 18 (256 KB,
zstd-like).  ``benchmarks/fig2_ratio_speed.py`` sweeps both.

Token wire format (before the Huffman pass)::

    [4B orig_len]
    sequence*:  [1B token: litlen(4) | matchlen-4 (4)]
                [litlen ext 255*] [literals]
                [3B LE offset] [matchlen ext 255*]      (offset <= 2^24-1)

It is LZ4's framing with 3-byte offsets so large windows fit; the Huffman
pass then entropy-codes the whole stream.  Dictionaries prime the window
(prefix), matching how zlib's ``zdict`` and LZ4's prefix mode work.
"""

from __future__ import annotations

import numpy as np

from . import huffman
from . import tokexec as _tok

__all__ = ["compress", "decompress", "lz77_tokens"]

_MIN_MATCH = 4
_LAST_LITERALS = 5


def _hash4_all(data: np.ndarray, log2_size: int) -> np.ndarray:
    """CF-style: 4-byte multiplicative hash, whole buffer in one vector pass."""
    n = data.size
    if n < 4:
        return np.zeros(0, dtype=np.uint32)
    w = (
        data[: n - 3].astype(np.uint32)
        | (data[1: n - 2].astype(np.uint32) << 8)
        | (data[2: n - 1].astype(np.uint32) << 16)
        | (data[3:].astype(np.uint32) << 24)
    )
    return ((w * np.uint32(2654435761)) >> np.uint32(32 - log2_size)).astype(np.uint32)


def _hash3_all(data: np.ndarray, log2_size: int) -> np.ndarray:
    """Reference-zlib-style: 3-byte rolling hash ((h<<5) ^ c) per position.

    Computed with the same shift-xor recurrence zlib uses (UPDATE_HASH);
    vectorized here only so the python harness isn't measuring interpreter
    overhead — the *collision behaviour* (what the paper's quadruplet change
    fixes) is identical to scalar zlib.
    """
    n = data.size
    if n < 3:
        return np.zeros(0, dtype=np.uint32)
    d = data.astype(np.uint32)
    h = ((d[: n - 2] << 10) ^ (d[1: n - 1] << 5) ^ d[2:]) & ((1 << log2_size) - 1)
    return h.astype(np.uint32)


def lz77_tokens(data: bytes, level: int = 5, mode: str = "cf",
                window_log: int = 15, dict_prefix: bytes = b"") -> bytes:
    """LZ77 match+emit pass -> token stream (pre-entropy-coding).

    ``mode="cf"``  : quadruplet hashing (CF-ZLIB levels 1-5 mechanism)
    ``mode="ref"`` : triplet hashing (reference zlib)
    ``level``      : chain search depth (1 -> greedy, 9 -> deep)
    ``window_log`` : max match distance = 2^window_log (15=zlib, 18=zstd-ish)
    """
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = memoryview(data).cast("B")   # buffer-protocol input, zero-copy
    prefix = dict_prefix[-(1 << window_log):] if dict_prefix else b""
    plen = len(prefix)
    # concatenation only materializes when a prefix actually exists
    buf = (prefix + bytes(data)) if plen else data
    src = np.frombuffer(buf, dtype=np.uint8)
    n = src.size
    out = bytearray()
    out += len(data).to_bytes(4, "little")
    if len(data) == 0:
        return bytes(out)

    def emit(lit_start: int, lit_end: int, mlen: int, dist: int):
        litlen = lit_end - lit_start
        t_lit = 15 if litlen >= 15 else litlen
        t_m = 0 if mlen == 0 else (15 if mlen - _MIN_MATCH >= 15 else mlen - _MIN_MATCH)
        out.append((t_lit << 4) | t_m)
        if litlen >= 15:
            rem = litlen - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(buf[lit_start:lit_end])
        if mlen:
            out.extend(int(dist).to_bytes(3, "little"))
            if mlen - _MIN_MATCH >= 15:
                rem = mlen - _MIN_MATCH - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    if len(data) < _MIN_MATCH + _LAST_LITERALS:
        emit(plen, n, 0, 0)
        return bytes(out)

    log2_size = 15 if level <= 5 else 16
    window = 1 << window_log
    hashes = _hash4_all(src, log2_size) if mode == "cf" else _hash3_all(src, log2_size)
    depth = {1: 1, 2: 2, 3: 4, 4: 8, 5: 16, 6: 32, 7: 64, 8: 128, 9: 256}[min(max(level, 1), 9)]
    head = np.full(1 << log2_size, -1, dtype=np.int64)
    prev = np.full(n, -1, dtype=np.int64)
    match_limit = n - _LAST_LITERALS
    scan_limit = n - _MIN_MATCH - _LAST_LITERALS + 1

    # seed the chains with the dictionary prefix
    for j in range(0, min(plen, hashes.size)):
        hj = hashes[j]
        prev[j] = head[hj]
        head[hj] = j

    def match_len(i: int, j: int) -> int:
        lim = match_limit
        total = 0
        step = 64
        while i + total < lim:
            k = min(step, lim - i - total)
            x = src[i + total: i + total + k]
            y = src[j + total: j + total + k]
            neq = np.nonzero(x != y)[0]
            if neq.size:
                return total + int(neq[0])
            total += k
            step = min(step * 4, 1 << 16)
        return lim - i

    anchor = plen
    i = plen
    misses = 0
    while i < scan_limit:
        h = hashes[i]
        cand = head[h]
        best_len, best_dist = 0, 0
        tries = depth
        while cand >= 0 and tries > 0 and i - cand <= window:
            probe = i + best_len
            if probe < match_limit and src[cand + best_len] == src[probe] and \
                    src[cand] == src[i]:
                mlen = match_len(i, cand)
                if mlen > best_len:
                    best_len, best_dist = mlen, i - cand
            cand = prev[cand]
            tries -= 1
        prev[i] = head[h]
        head[h] = i
        if best_len >= _MIN_MATCH:
            emit(anchor, i, best_len, best_dist)
            step_ins = 1 if level >= 6 else 4   # chain insert density
            for j in range(i + 1, min(i + best_len, scan_limit), step_ins):
                hj = hashes[j]
                prev[j] = head[hj]
                head[hj] = j
            i += best_len
            anchor = i
            misses = 0
        else:
            misses += 1
            i += 1 + (misses >> 6)   # acceleration skip on incompressible data
    emit(anchor, n, 0, 0)
    return bytes(out)


def _untokenize(tokens: bytes, dict_prefix: bytes = b"") -> bytes:
    """Two-pass vectorized token decode (repro_torch.core.tokexec): parse all
    sequence headers into numpy arrays in one scan, then place literals and
    replay matches from a cumulative output-position table."""
    orig_len = int.from_bytes(tokens[:4], "little")
    return _tok.decode_token_stream(tokens, dict_prefix, orig_len, base=4,
                                    offset_bytes=3, name="repro_deflate")


def compress(data: bytes, level: int = 5, mode: str = "cf",
             window_log: int = 15, dictionary: bytes | None = None) -> bytes:
    """LZ77 pass + Huffman entropy pass. Header byte records the mode/window."""
    tokens = lz77_tokens(data, level=level, mode=mode, window_log=window_log,
                         dict_prefix=dictionary or b"")
    hdr = bytes([(0 if mode == "cf" else 1) | (window_log << 1)])
    return hdr + huffman.encode(tokens)


def decompress(comp: bytes, orig_len: int, dictionary: bytes | None = None) -> bytes:
    if not comp:
        return b""
    tokens = huffman.decode(comp[1:])
    return _untokenize(tokens, dictionary or b"")

"""From-scratch LZ4 *block format* codec (paper §2.2) — vectorized cores.

The real ``lz4`` bindings are not available offline, so this implements the
LZ4 block wire format (https://github.com/lz4/lz4 — lz4_Block_format.md)
independently:

  sequence := token | [litlen ext 255*] | literals | offset(2B LE)
              | [matchlen ext 255*]
  token    := (literal_length:4 | match_length-4 :4)
  rules    := last sequence is literals-only; matches >= 4 bytes;
              offset in [1, 65535]; last 5 bytes are always literals;
              last match must end >= 12 bytes before the block end.

Two compressors, mirroring the reference library:

* ``level <= 3`` — **fast/greedy**: single-probe hash table (the reference
  LZ4 fast path), with candidate positions probed in vectorized chunks —
  ``table[hashes[i:i+K]]`` is compared against the precomputed 4-byte
  words of a whole chunk at once, the first accepted match resolved, and
  the scan jumps past it (the paper's SIMD quadruplet-hashing mechanism
  applied to the probe loop itself, not just the hash precompute).
* ``level >= 4`` — **HC-ish**: chained hash search; chain depth grows with
  level ("LZ4-HC typically results in ~20% better ratio", paper §2.2).

``decompress_block`` is two-pass: pass 1 parses every sequence header into
numpy ``(litstart, litlen, offset, mlen)`` arrays in one cheap scan (token
positions only; extension bytes are rare and patched sparsely), pass 2
derives all output positions from one cumulative sum, scatters every
literal run with a single vectorized gather, and replays matches as plain
slice memcpys.  The pre-vectorization serial decoder is kept as
``_decompress_block_legacy`` — it is the baseline ``benchmarks/
fig_entropy.py`` and the CI perf-smoke compare against.

The numpy cores lift throughput well above the old per-sequence Python
loops (see ``benchmarks/fig_entropy.py`` for current numbers), but this is
still interpreter-orchestrated numpy, not native code: absolute MB/s
remains far below C lz4, so benchmarks keep reporting the handicap
explicitly (EXPERIMENTS.md §Fidelity) and use C-backed zstd negative
levels as the native-speed LZ4-class proxy.
"""

from __future__ import annotations

import numpy as np

from . import tokexec as _tok

__all__ = ["compress_block", "decompress_block"]

_MIN_MATCH = 4
_MFLIMIT = 12      # last match must end this many bytes before block end
_LAST_LITERALS = 5
_PROBE_CHUNK = 64  # greedy fast path: candidate positions probed per batch


def _words4(data: np.ndarray) -> np.ndarray:
    """Little-endian 4-byte window ("quadruplet") at every position."""
    n = data.size
    if n < 4:
        return np.zeros(0, dtype=np.uint32)
    return (
        data[: n - 3].astype(np.uint32)
        | (data[1: n - 2].astype(np.uint32) << 8)
        | (data[2: n - 1].astype(np.uint32) << 16)
        | (data[3:].astype(np.uint32) << 24)
    )


def _hash_words(words: np.ndarray, log2_size: int) -> np.ndarray:
    """Vectorized multiplicative hash of precomputed 4-byte windows."""
    return ((words * np.uint32(2654435761))
            >> np.uint32(32 - log2_size)).astype(np.uint32)


def _match_len(a: np.ndarray, i: int, j: int, limit: int) -> int:
    """Length of common prefix of a[i:limit] and a[j:...] (vectorized probe)."""
    n = limit - i
    if n <= 0:
        return 0
    step = 64
    total = 0
    while total < n:
        k = min(step, n - total)
        x = a[i + total: i + total + k]
        y = a[j + total: j + total + k]
        neq = np.nonzero(x != y)[0]
        if neq.size:
            return total + int(neq[0])
        total += k
        step = min(step * 4, 1 << 16)
    return n


def compress_block(data: bytes, level: int = 1, dict_prefix: bytes = b"") -> bytes:
    """Compress ``data`` into an LZ4 block. Never fails; worst case expands.

    ``dict_prefix`` primes the match window (real-LZ4 dictionary mode): the
    prefix seeds the hash table and is matchable, but is never emitted —
    the decoder must be given the same prefix.
    """
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = memoryview(data).cast("B")   # buffer-protocol input, zero-copy
    prefix = dict_prefix[-65535:] if dict_prefix else b""
    plen = len(prefix)
    if plen:
        buf = prefix + bytes(data)
        src = np.frombuffer(buf, dtype=np.uint8)
        data = buf  # emit() slices literals out of the combined buffer
    else:
        src = np.frombuffer(data, dtype=np.uint8)
    n = src.size
    out = bytearray()
    if n == plen:
        return b"\x00"

    def emit(lit_start: int, lit_end: int, mlen: int, dist: int):
        litlen = lit_end - lit_start
        token_lit = 15 if litlen >= 15 else litlen
        token_match = 0 if mlen == 0 else (15 if mlen - _MIN_MATCH >= 15 else mlen - _MIN_MATCH)
        out.append((token_lit << 4) | token_match)
        if litlen >= 15:
            rem = litlen - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(data[lit_start:lit_end])
        if mlen:
            out.append(dist & 0xFF)
            out.append((dist >> 8) & 0xFF)
            if mlen - _MIN_MATCH >= 15:
                rem = mlen - _MIN_MATCH - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    if n - plen < _MFLIMIT + 1:
        emit(plen, n, 0, 0)
        return bytes(out)

    log2_size = 14 if level <= 3 else 16
    words = _words4(src)
    hashes = _hash_words(words, log2_size)
    match_limit = n - _LAST_LITERALS
    scan_limit = n - _MFLIMIT

    if level <= 3:
        # ---- greedy fast path: single-slot hash table, batched probing.
        # Probe _PROBE_CHUNK candidate positions per step: one gather pulls
        # all their table slots, one compare accepts/rejects every quadruplet
        # at once, and only an accepted match drops back to scalar code.
        # The table is only refreshed per chunk, which would go blind to
        # matches closer than the chunk (runs, byte-plane periodicity), so a
        # one-pass periodic-candidate table covers distances 1..4.
        near = np.zeros(hashes.size, dtype=np.uint8)
        for delta in (4, 3, 2, 1):  # smallest period wins (longest extension)
            eq = words[delta:] == words[:-delta]
            near[delta:][eq] = delta
        table = np.full(1 << log2_size, -1, dtype=np.int64)
        seed = min(plen, hashes.size)
        if seed:  # dictionary prefix; duplicate hashes keep the last (newest)
            table[hashes[:seed]] = np.arange(seed)
        anchor = plen
        i = plen
        while i < scan_limit:
            end = min(i + _PROBE_CHUNK, scan_limit)
            pos = np.arange(i, end, dtype=np.int64)
            hs = hashes[i:end]
            cands = table[hs]
            nd = near[i:end]
            # cands == -1 gathers words[-1]: in-bounds garbage, masked below
            ok = (nd > 0) | ((cands >= 0) & (pos - cands <= 65535)
                             & (words[cands] == words[pos]))
            hits = np.flatnonzero(ok)
            if hits.size == 0:
                table[hs] = pos
                i = end
                continue
            j = int(hits[0])
            table[hs[:j + 1]] = pos[:j + 1]
            ii = i + j
            cand = ii - int(nd[j]) if nd[j] else int(cands[j])
            # quadruplet equality guarantees >= _MIN_MATCH here: scan stops
            # _MFLIMIT before the end, so ii+4 is always under match_limit
            mlen = _match_len(src, ii, cand, match_limit)
            emit(anchor, ii, mlen, ii - cand)
            i = ii + mlen
            anchor = i
    else:
        # ---- HC path: chained hash search, depth scales with level
        depth = {4: 4, 5: 8, 6: 16, 7: 32, 8: 64, 9: 128}.get(min(level, 9), 16)
        head = np.full(1 << log2_size, -1, dtype=np.int64)
        prev = np.full(n, -1, dtype=np.int64)
        for j in range(0, min(plen, hashes.size)):   # seed with dictionary
            hj = hashes[j]
            prev[j] = head[hj]
            head[hj] = j
        anchor = plen
        i = plen
        while i < scan_limit:
            h = hashes[i]
            cand = head[h]
            best_len, best_dist = 0, 0
            tries = depth
            while cand >= 0 and tries > 0 and i - cand <= 65535:
                # quick reject: a longer match must at least extend past best_len
                probe = i + best_len
                if probe < match_limit and cand + best_len < n and src[cand + best_len] == src[probe]:
                    mlen = _match_len(src, i, cand, match_limit)
                    if mlen > best_len:
                        best_len, best_dist = mlen, i - cand
                cand = prev[cand]
                tries -= 1
            prev[i] = head[h]
            head[h] = i
            if best_len >= _MIN_MATCH:
                emit(anchor, i, best_len, best_dist)
                # insert skipped positions into the chain (sparsely, for speed)
                for j in range(i + 1, min(i + best_len, scan_limit), 4):
                    hj = hashes[j]
                    prev[j] = head[hj]
                    head[hj] = j
                i += best_len
                anchor = i
            else:
                i += 1

    emit(anchor, n, 0, 0)  # trailing literals
    return bytes(out)


def decompress_block(comp: bytes, orig_len: int, dict_prefix: bytes = b"") -> bytes:
    """Decompress an LZ4 block of known decompressed size (two-pass,
    vectorized — see ``repro_torch.core.tokexec``).

    ``dict_prefix`` must be the same window-priming dictionary used at
    compression time (matches may reference into it)."""
    prefix = dict_prefix[-65535:] if dict_prefix else b""
    return _tok.decode_token_stream(comp, prefix, orig_len, base=0,
                                    offset_bytes=2, name="LZ4 block")


def _decompress_block_legacy(comp: bytes, orig_len: int,
                             dict_prefix: bytes = b"") -> bytes:
    """The pre-vectorization single-pass serial decoder, kept verbatim as
    the perf baseline for ``benchmarks/fig_entropy.py`` and as a cross-check
    oracle in tests."""
    prefix = dict_prefix[-65535:] if dict_prefix else b""
    plen = len(prefix)
    src = comp
    dst = bytearray(plen + orig_len)
    dst[:plen] = prefix
    i = 0
    o = plen
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                b = src[i]
                i += 1
                litlen += b
                if b != 255:
                    break
        if litlen:
            dst[o:o + litlen] = src[i:i + litlen]
            i += litlen
            o += litlen
        if i >= n:
            break  # last sequence: literals only
        dist = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 0xF) + _MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        ref = o - dist
        if dist >= mlen:  # non-overlapping: one slice copy
            dst[o:o + mlen] = dst[ref:ref + mlen]
            o += mlen
        else:             # overlapping match: replicate pattern
            while mlen > 0:
                chunk = min(mlen, o - ref)
                dst[o:o + chunk] = dst[ref:ref + chunk]
                o += chunk
                mlen -= chunk
    if o - plen != orig_len:
        raise ValueError(f"LZ4 block decoded {o - plen} bytes, expected {orig_len}")
    return bytes(dst[plen:])

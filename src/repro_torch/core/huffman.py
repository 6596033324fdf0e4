"""Canonical Huffman coder over byte symbols — N-stream vectorized core.

The entropy stage for ``repro_deflate`` (and its large-window "repro-zstd"
variant).  ZLIB's second pass is Huffman coding (paper §2); this module is a
self-contained, numpy-vectorized encoder with a table-driven decoder so the
paper's "entropy stage" mechanism exists in our from-scratch codec rather
than being inherited opaquely from libz.

Two wire formats, auto-detected by :func:`decode`:

**Legacy 1-stream** (every blob written before the vectorized cores PR;
still produced for small inputs, little-endian ints, MSB-first bits)::

    [2B n_symbols_present][for each present symbol: 1B symbol, then packed
     4-bit code lengths][4B n_encoded_symbols][packed bitstream]

**V2 N-stream container** (zstd Huff0-4X style; DESIGN.md §9).  The input
is split into N chunks of ``ceil(n/N)`` symbols, each chunk coded into its
own byte-aligned bitstream with the *shared* code table, so the decoder can
advance all N streams in lockstep with batched numpy table lookups::

    [2B magic "FH"]        -- LE value 0x4846 > 256, impossible as a legacy
                              n_symbols_present, so detection is exact
    [1B version = 2]
    [1B n_streams]
    [2B n_symbols_present][symbols][packed 4-bit lengths]   (as legacy)
    [4B n_encoded_symbols]
    [4B per-stream bitstream byte length] * n_streams
    [stream bitstreams, concatenated]

Code lengths are capped at 15 bits (deflate's own cap) via the standard
length-limiting fix-up.  Encoders pack bits through a vectorized uint64
bit-accumulator (no per-bit Python work); the V2 decoder gathers all N
stream positions per step, so interpreter overhead amortizes across
streams — which is why, unlike C Huff0's fixed N=4, ``n_streams`` scales
with input size (min 4 for Huff0 parity, more for big baskets).
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["encode", "decode", "code_lengths", "canonical_codes"]

_MAX_BITS = 15

_V2_MAGIC = b"FH"        # LE uint16 0x4846 = 18502 > 256 == max legacy n_present
_V2_VERSION = 2
_V2_MIN_SYMBOLS = 4096   # below this the 1-stream format is smaller & fast enough
_STREAM_CHUNK = 8192     # target symbols per stream (bounds lockstep rounds)
_MIN_STREAMS = 4         # Huff0-4X parity
_MAX_STREAMS = 128


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths (capped at _MAX_BITS) for a 256-entry freq table."""
    sym = np.nonzero(freqs)[0]
    n = sym.size
    lengths = np.zeros(256, dtype=np.uint8)
    if n == 0:
        return lengths
    if n == 1:
        lengths[sym[0]] = 1
        return lengths
    # heap of (freq, tiebreak, node); leaves are ints, internals are tuples
    heap = [(int(freqs[s]), int(s), int(s)) for s in sym]
    heapq.heapify(heap)
    cnt = 256
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, cnt, (n1, n2)))
        cnt += 1
    # walk tree for depths
    stack = [(heap[0][2], 0)]
    while stack:
        node, d = stack.pop()
        if isinstance(node, tuple):
            stack.append((node[0], d + 1))
            stack.append((node[1], d + 1))
        else:
            lengths[node] = max(d, 1)
    # length-limit to _MAX_BITS (Kraft fix-up: demote overlong, then re-pay)
    if lengths.max() > _MAX_BITS:
        lengths = np.minimum(lengths, _MAX_BITS)
        # Kraft sum K = sum(2^-len) must be <= 1 in units of 2^-MAX_BITS;
        # demote (lengthen) the rarest symbols until it holds.
        unit = 1 << _MAX_BITS
        k = int(np.sum(unit >> lengths[lengths > 0].astype(np.int64)))
        if k > unit:
            # demote symbols with the smallest freq first
            order = np.argsort(freqs + (lengths == 0) * (1 << 62))
            i = 0
            while k > unit and i < order.size:
                s = order[i]
                while lengths[s] < _MAX_BITS and k > unit:
                    k -= unit >> int(lengths[s])
                    lengths[s] += 1
                    k += unit >> int(lengths[s])
                i += 1
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values (uint16) for given code lengths."""
    codes = np.zeros(256, dtype=np.uint16)
    code = 0
    for bits in range(1, _MAX_BITS + 1):
        for s in np.nonzero(lengths == bits)[0]:
            codes[s] = code
            code += 1
        code <<= 1
    return codes


def _pack_bits(symbols: np.ndarray, codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Pack per-symbol canonical codes MSB-first via uint64 accumulators.

    Each code is left-aligned into a 64-bit lane, shifted to its absolute
    bit offset, and OR-merged per output word with a segmented ``reduceat``
    (codes are emitted in position order, so word indices arrive sorted).
    A code can straddle at most two words (15 < 64), handled by a spill
    pass into word+1.
    """
    lens = lengths[symbols].astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return b""
    ends = np.cumsum(lens)
    starts = ends - lens
    cv = codes[symbols].astype(np.uint64)
    L = lens.astype(np.uint64)
    w = starts >> 6
    b = (starts & 63).astype(np.uint64)
    top = cv << (np.uint64(64) - L)          # code MSB at word bit 63
    hi = top >> b
    nwords = (total + 63) >> 6
    words = np.zeros(nwords, dtype=np.uint64)

    def _or_segments(idx: np.ndarray, vals: np.ndarray) -> None:
        # idx sorted non-decreasing: OR together runs of equal word index
        first = np.empty(idx.size, dtype=bool)
        first[0] = True
        np.not_equal(idx[1:], idx[:-1], out=first[1:])
        seg = np.flatnonzero(first)
        words[idx[seg]] |= np.bitwise_or.reduceat(vals, seg)

    _or_segments(w, hi)
    spill = (b + L) > np.uint64(64)
    if spill.any():
        bs = b[spill]                        # b >= 50 here, so shifts are < 64
        _or_segments(w[spill] + 1, top[spill] << (np.uint64(64) - bs))
    return words.astype(">u8").tobytes()[: (total + 7) >> 3]


def _table_header(lengths: np.ndarray) -> bytes:
    """[2B n_present][present symbols][packed 4-bit lengths] (both formats)."""
    present = np.nonzero(lengths)[0]
    out = bytearray()
    out += int(present.size).to_bytes(2, "little")
    out += present.astype(np.uint8).tobytes()
    ls = lengths[present]
    if ls.size % 2:
        ls = np.concatenate([ls, [0]])
    out += ((ls[0::2].astype(np.uint8) << 4) | ls[1::2].astype(np.uint8)).tobytes()
    return bytes(out)


def _parse_table(blob: bytes, pos: int) -> tuple[np.ndarray, int]:
    """Invert :func:`_table_header`; returns (lengths[256], next offset)."""
    n_present = int.from_bytes(blob[pos:pos + 2], "little")
    pos += 2
    lengths = np.zeros(256, dtype=np.uint8)
    if n_present == 0:
        return lengths, pos
    present = np.frombuffer(blob, dtype=np.uint8, count=n_present, offset=pos)
    pos += n_present
    n_len_bytes = (n_present + 1) // 2
    packed = np.frombuffer(blob, dtype=np.uint8, count=n_len_bytes, offset=pos)
    pos += n_len_bytes
    ls = np.zeros(n_len_bytes * 2, dtype=np.uint8)
    ls[0::2] = packed >> 4
    ls[1::2] = packed & 0xF
    lengths[present] = ls[:n_present]
    return lengths, pos


def _pick_streams(n_syms: int) -> int:
    if n_syms < _V2_MIN_SYMBOLS:
        return 1
    return max(_MIN_STREAMS, min(_MAX_STREAMS, n_syms // _STREAM_CHUNK))


def encode(data: bytes, n_streams: int | None = None) -> bytes:
    """Huffman-encode a byte string (self-describing header + bitstream).

    ``n_streams=None`` auto-selects: the legacy 1-stream format for small
    inputs, the V2 N-stream container otherwise.  Forcing ``n_streams=1``
    reproduces the legacy wire format byte-identically.
    """
    arr = np.frombuffer(data, dtype=np.uint8)
    if n_streams is None:
        n_streams = _pick_streams(arr.size)
    if not 1 <= n_streams <= 255:
        raise ValueError(f"n_streams must be 1..255, got {n_streams}")
    freqs = np.bincount(arr, minlength=256)
    lengths = code_lengths(freqs)
    codes = canonical_codes(lengths)
    if n_streams == 1:
        out = bytearray(_table_header(lengths))
        out += int(arr.size).to_bytes(4, "little")
        out += _pack_bits(arr, codes, lengths)
        return bytes(out)
    chunk = -(-arr.size // n_streams) if arr.size else 0
    streams = [_pack_bits(arr[s * chunk:(s + 1) * chunk], codes, lengths)
               for s in range(n_streams)]
    out = bytearray(_V2_MAGIC)
    out.append(_V2_VERSION)
    out.append(n_streams)
    out += _table_header(lengths)
    out += int(arr.size).to_bytes(4, "little")
    for s in streams:
        out += len(s).to_bytes(4, "little")
    for s in streams:
        out += s
    return bytes(out)


def _build_table(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(tbl_sym, tbl_len, maxbits): every maxbits-bit prefix -> (symbol, len)."""
    maxbits = int(lengths.max())
    if maxbits == 0:
        raise ValueError("huffman blob has an empty code table but symbols")
    codes = canonical_codes(lengths)
    tbl_sym = np.zeros(1 << maxbits, dtype=np.uint8)
    tbl_len = np.zeros(1 << maxbits, dtype=np.uint8)
    for s in np.nonzero(lengths)[0]:
        L = int(lengths[s])
        base = int(codes[s]) << (maxbits - L)
        span = 1 << (maxbits - L)
        tbl_sym[base: base + span] = s
        tbl_len[base: base + span] = L
    return tbl_sym, tbl_len, maxbits


def _prefix_vals(raw: np.ndarray, maxbits: int) -> np.ndarray:
    """vals[p] = int value of the ``maxbits`` bits starting at bit ``p``.

    Computed per byte through a 24-bit sliding word (8 shifted copies), so
    the whole table costs a few vector passes instead of an 8x unpackbits +
    matmul.
    """
    B = np.concatenate([raw, np.zeros(2, dtype=np.uint8)]).astype(np.uint32)
    w24 = (B[:-2] << np.uint32(16)) | (B[1:-1] << np.uint32(8)) | B[2:]
    shifts = (np.uint32(9) - np.arange(8, dtype=np.uint32))[None, :]
    vals = ((w24[:, None] >> shifts) & np.uint32(0x7FFF)).reshape(-1)
    if maxbits < 15:
        vals >>= np.uint32(15 - maxbits)
    return vals


def _decode_v2(blob: bytes) -> bytes:
    version = blob[2]
    if version != _V2_VERSION:
        raise ValueError(f"unsupported huffman container version {version}")
    n_streams = blob[3]
    lengths, pos = _parse_table(blob, 4)
    n_syms = int.from_bytes(blob[pos:pos + 4], "little")
    pos += 4
    slens = np.frombuffer(blob, dtype="<u4", count=n_streams, offset=pos).astype(np.int64)
    pos += 4 * n_streams
    if n_syms == 0:
        return b""
    tbl_sym, tbl_len, maxbits = _build_table(lengths)
    raw = np.frombuffer(blob, dtype=np.uint8, offset=pos)
    # Total over-advance past the data end is < n_streams lockstep rounds
    # of <= 15 bits each (short tail streams); pad so gathers stay in range.
    pad = 2 * n_streams + 64
    raw = np.concatenate([raw, np.zeros(pad, dtype=np.uint8)])
    vals = _prefix_vals(raw, maxbits)
    bitpos = np.concatenate([[0], np.cumsum(slens)[:-1]]) * 8
    chunk = -(-n_syms // n_streams)
    out = np.empty((chunk, n_streams), dtype=np.uint8)
    tl = tbl_len.astype(np.int64)
    ts = tbl_sym
    # Lockstep: one table-lookup round decodes one symbol from EVERY stream.
    for r in range(chunk):
        w = vals[bitpos]
        out[r] = ts[w]
        bitpos += tl[w]
    # out[r, s] is symbol s*chunk + r; transpose-ravel restores input order
    # and truncation drops the short last stream's garbage tail.
    return out.T.reshape(-1)[:n_syms].tobytes()


def _decode_legacy(blob: bytes) -> bytes:
    """Serial 1-stream decoder (the pre-vectorization path, kept verbatim:
    it is both the legacy-format reader and the perf baseline that
    ``benchmarks/fig_entropy.py`` measures the lockstep core against)."""
    n_present = int.from_bytes(blob[:2], "little")
    if n_present == 0:
        return b""
    lengths, pos = _parse_table(blob, 0)
    n_syms = int.from_bytes(blob[pos:pos + 4], "little")
    pos += 4
    tbl_sym, tbl_len, maxbits = _build_table(lengths)
    bits = np.unpackbits(np.frombuffer(blob, dtype=np.uint8, offset=pos))
    out = np.empty(n_syms, dtype=np.uint8)
    # Vectorized prefix values: vals[i] = int value of bits[i:i+maxbits].
    # The symbol loop itself stays serial (variable-length decode has a true
    # dependency chain) but each step is just two table lookups.
    pad = np.concatenate([bits, np.zeros(maxbits, dtype=np.uint8)])
    pows = (1 << np.arange(maxbits - 1, -1, -1, dtype=np.uint32))
    vals = np.lib.stride_tricks.sliding_window_view(pad, maxbits)[: bits.size + 1] @ pows
    bitpos = 0
    tl = [int(v) for v in tbl_len]
    ts = tbl_sym
    vlist = vals.tolist()
    for i in range(n_syms):
        w = vlist[bitpos]
        out[i] = ts[w]
        bitpos += tl[w]
    return out.tobytes()


def decode(blob: bytes) -> bytes:
    """Invert :func:`encode`; auto-detects the legacy and V2 wire formats."""
    if blob[:2] == _V2_MAGIC:
        return _decode_v2(blob)
    return _decode_legacy(blob)

"""Checksums: naive vs vectorized adler32/crc32.

Reproduces the CF-ZLIB mechanism from the paper's §2.1:

* adler32 hotspot: CF-ZLIB uses ``_mm_sad_epu8`` (SSE byte sum-of-absolute-
  differences) to sum bytes 16-at-a-time and shuffle-adds to accumulate the
  position-weighted term.  The numpy analogue below does exactly the same
  algebra — block byte-sums for ``A`` and a weighted prefix formulation for
  ``B`` — trading the per-byte serial loop for wide vector reductions.
* crc32 hotspot: hardware ``crc32`` instructions vs table lookup.  We expose
  three tiers: ``crc32_naive`` (bitwise, the 1995-style loop),
  ``crc32_table`` (byte-at-a-time table — classic software), and
  ``crc32_slice8`` (vectorized slice-by-8 over numpy — the "hardware
  assisted" stand-in; on CPython the true hardware path is
  ``zlib.crc32``, also exposed for the benchmark's top tier).

The benchmark in ``benchmarks/fig45_cfzlib.py`` measures these tiers and
reproduces the structure of the paper's Figures 4–5.

All implementations agree bit-exactly with ``zlib.adler32``/``zlib.crc32``.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = [
    "adler32_naive",
    "adler32_vector",
    "adler32_hw",
    "crc32_naive",
    "crc32_table",
    "crc32_slice8",
    "crc32_hw",
]

_MOD = 65521  # largest prime < 2^16


# ---------------------------------------------------------------------------
# adler32
# ---------------------------------------------------------------------------

def adler32_naive(data: bytes, value: int = 1) -> int:
    """Reference per-byte loop (the pre-CF hot spot)."""
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    for byte in data:
        a = (a + byte) % _MOD
        b = (b + a) % _MOD
    return (b << 16) | a


def adler32_vector(data: bytes, value: int = 1, block: int = 1 << 16) -> int:
    """Vectorized adler32 — the ``_mm_sad_epu8`` trick in numpy.

    For a block of n bytes x_0..x_{n-1} starting from state (a, b):
        a' = a + sum(x)
        b' = b + n*a + sum((n - i) * x_i)
    Both sums are wide vector reductions; the weighted sum is the numpy
    equivalent of CF-ZLIB's shuffle-add accumulation of SAD partial sums.
    Blocks are sized so int64 accumulators cannot overflow.
    """
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    arr = np.frombuffer(data, dtype=np.uint8)
    n_total = arr.size
    for off in range(0, n_total, block):
        x = arr[off:off + block].astype(np.int64)
        n = x.size
        s = int(x.sum())
        w = int((np.arange(n, 0, -1, dtype=np.int64) * x).sum())
        b = (b + n * a + w) % _MOD
        a = (a + s) % _MOD
    return (b << 16) | a


def adler32_hw(data: bytes, value: int = 1) -> int:
    """zlib's C implementation — the 'shipped library' tier."""
    return zlib.adler32(data, value) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# crc32 (IEEE 802.3 polynomial, reflected: 0xEDB88320)
# ---------------------------------------------------------------------------

_POLY = 0xEDB88320


def _make_table(n_slices: int = 8) -> np.ndarray:
    tab = np.zeros((n_slices, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        tab[0, i] = c
    for s in range(1, n_slices):
        for i in range(256):
            c = tab[s - 1, i]
            tab[s, i] = (c >> 8) ^ tab[0, c & 0xFF]
    return tab


_TABLE = _make_table(8)
_T0 = [int(x) for x in _TABLE[0]]


def crc32_naive(data: bytes, value: int = 0) -> int:
    """Bitwise loop — the unaccelerated tier ("no hardware crc32")."""
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def crc32_table(data: bytes, value: int = 0) -> int:
    """Byte-at-a-time table lookup — classic software crc32."""
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _T0[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32_slice8(data: bytes, value: int = 0) -> int:
    """Slice-by-8: processes 8 bytes per step with table-parallel lookups.

    This is the software analogue of the hardware-crc32 path: the inner
    dependency chain is per-8-bytes instead of per-byte, and the eight
    table lookups vectorize.  (numpy gathers make the lookups wide; the
    chain over 8-byte words remains, as it does on real slice-by-8.)
    """
    crc = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    arr = np.frombuffer(data, dtype=np.uint8)
    n8 = (arr.size // 8) * 8
    words = arr[:n8].reshape(-1, 8)
    t = _TABLE
    for row in words:
        x = crc ^ int(row[0]) ^ (int(row[1]) << 8) ^ (int(row[2]) << 16) ^ (int(row[3]) << 24)
        crc = (
            int(t[7, x & 0xFF])
            ^ int(t[6, (x >> 8) & 0xFF])
            ^ int(t[5, (x >> 16) & 0xFF])
            ^ int(t[4, (x >> 24) & 0xFF])
            ^ int(t[3, int(row[4])])
            ^ int(t[2, int(row[5])])
            ^ int(t[1, int(row[6])])
            ^ int(t[0, int(row[7])])
        )
    for byte in arr[n8:]:
        crc = (crc >> 8) ^ _T0[(crc ^ int(byte)) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32_hw(data: bytes, value: int = 0) -> int:
    """zlib's C crc32 — the hardware/asm tier on this host."""
    return zlib.crc32(data, value) & 0xFFFFFFFF

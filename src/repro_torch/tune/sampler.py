"""Deterministic stratified payload sampling for trial compressions.

The tuner never compresses a whole branch to decide its codec: it measures
trial configs on a small *sample* that has to be (a) cheap, (b)
deterministic — same branch bytes, same sample, same decision — and (c)
representative of the whole branch, not just its head.  A head-only sample
is exactly the failure mode the paper's offset-array discussion warns
about: data whose first basket looks monotone/low-entropy while the tail
does not (appended columns, mixed-phase event files) gets mistuned.

``stratified_sample`` therefore takes ``windows`` equal-width windows at
evenly spaced offsets across the full buffer — head, body and tail all
contribute — and concatenates them.  Window boundaries are aligned down to
``itemsize`` so preconditioners (shuffle/delta/bitshuffle) see whole
elements; window *joins* introduce one artificial discontinuity each,
which costs delta-style preconditioners a few bytes per window and is
identical for every candidate, so rankings are unaffected.

``byte_entropy`` is the drift detector's cheap distribution fingerprint:
order-0 Shannon entropy in bits/byte from a 256-bin histogram.
"""

from __future__ import annotations

import numpy as np

__all__ = ["stratified_sample", "sample_offsets", "byte_entropy",
           "DEFAULT_SAMPLE_BYTES", "DEFAULT_WINDOWS"]

DEFAULT_SAMPLE_BYTES = 1 << 16   # 64 KiB of trial payload per branch
DEFAULT_WINDOWS = 8


def _as_u8(buf) -> np.ndarray:
    a = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    if a.dtype != np.uint8:
        a = a.view(np.uint8)
    return a.reshape(-1)


def sample_offsets(n: int, itemsize: int = 1,
                   target_bytes: int = DEFAULT_SAMPLE_BYTES,
                   windows: int = DEFAULT_WINDOWS) -> tuple[list[int], int]:
    """(window start offsets, window byte width) for an ``n``-byte buffer.

    Deterministic in (n, itemsize, target_bytes, windows).  Starts are
    evenly spaced over [0, n - width] and aligned down to ``itemsize``;
    the width is ``target_bytes // windows`` aligned likewise.  When the
    buffer fits in ``target_bytes`` a single [0, n) window covers it.
    """
    itemsize = max(int(itemsize), 1)
    if n <= target_bytes:
        return [0], n
    k = max(int(windows), 1)
    w = max((target_bytes // k) // itemsize * itemsize, itemsize)
    k = min(k, max(n // w, 1))
    if k <= 1:
        return [0], min(w, n)
    span = n - w
    starts = [(span * i // (k - 1)) // itemsize * itemsize for i in range(k)]
    # evenly spaced + aligned can collide only when windows overlap; keep
    # first occurrence so the sample never double-counts a region
    seen, out = set(), []
    for s in starts:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out, w


def stratified_sample(buf, itemsize: int = 1,
                      target_bytes: int = DEFAULT_SAMPLE_BYTES,
                      windows: int = DEFAULT_WINDOWS) -> np.ndarray:
    """Concatenated stratified windows of ``buf`` as a uint8 array.

    Zero-copy when the whole buffer fits in ``target_bytes`` (the returned
    array views ``buf``); otherwise one small allocation of
    ``<= target_bytes`` bytes.
    """
    a = _as_u8(buf)
    starts, w = sample_offsets(a.size, itemsize, target_bytes, windows)
    if len(starts) == 1 and w == a.size:
        return a
    return np.concatenate([a[s:s + w] for s in starts])


def byte_entropy(buf) -> float:
    """Order-0 Shannon entropy of ``buf`` in bits per byte (0.0 .. 8.0)."""
    a = _as_u8(buf)
    if a.size == 0:
        return 0.0
    counts = np.bincount(a, minlength=256)
    p = counts[counts > 0] / a.size
    return float(-(p * np.log2(p)).sum())

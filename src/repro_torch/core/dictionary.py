"""Compression dictionaries (paper §2.3).

ZSTD trains a dictionary from sample buffers; the paper's observation is
that the *same* trained dictionary also helps ZLIB (via ``zdict``) and LZ4
(via window priming) — "the generated dictionaries are useable for ZLIB and
LZ4 as well" (§3).

``train_dictionary`` uses libzstd's COVER trainer when the ``zstandard``
package is present; offline (this container) it falls back to a pure-numpy
frequent-segment trainer implementing the same idea COVER formalizes:
find byte segments that recur across samples and concatenate them,
rarest-first, so the most frequent material sits at the *end* of the
dictionary (closest to the compression window — both zlib's ``zdict`` and
LZ4 prefix priming find near matches cheapest).

``DictPolicy``'s sizing rule answers the paper's open sizing question with
a simple, measurable heuristic (~5% of corpus, clamped), which
``benchmarks/fig_dict.py`` sweeps.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Optional

import numpy as np

try:
    import zstandard as _zstd
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover
    HAVE_ZSTD = False

__all__ = ["train_dictionary", "train_dictionary_numpy", "suggest_dict_size", "HAVE_ZSTD"]


def suggest_dict_size(samples: list[bytes], per_sample_frac: float = 0.05,
                      lo: int = 1 << 10, hi: int = 1 << 17) -> int:
    """Sizing rule: ~5% of total sample bytes, clamped to [1 KiB, 128 KiB].

    Rationale (recorded for the paper's open question): the dictionary is
    stored once per branch in the TOC, amortized over all its baskets, so it
    pays off when dict_size < sum(per-basket savings).  Empirically the
    savings curve flattens near 5% of corpus size for small-buffer corpora
    (see benchmarks/fig_dict.py sweep).
    """
    total = sum(len(s) for s in samples)
    return max(lo, min(hi, int(total * per_sample_frac)))


def train_dictionary_numpy(samples: list[bytes], size: int,
                           seg: int = 16, top_frac: float = 4.0) -> bytes:
    """COVER-style frequent-segment dictionary, pure numpy.

    1. slide a ``seg``-byte window over every sample (stride seg//2),
    2. count segment frequencies across the corpus,
    3. keep segments seen >= 2 times, greedily pack them into ``size`` bytes
       ordered rare->frequent (frequent material ends up nearest the window).
    """
    counts: Counter = Counter()
    stride = max(1, seg // 2)
    for s in samples:
        a = np.frombuffer(s, dtype=np.uint8)
        if a.size < seg:
            counts[bytes(a)] += 1
            continue
        wins = np.lib.stride_tricks.sliding_window_view(a, seg)[::stride]
        for w in wins:
            counts[w.tobytes()] += 1
    repeated = [(c, s) for s, c in counts.items() if c >= 2]
    if not repeated:
        return b"".join(samples)[:size]
    # most frequent last; dedupe overlapping content greedily
    repeated.sort(key=lambda cs: cs[0])
    budget = int(size / max(seg, 1) * top_frac)
    chosen = [s for _, s in repeated[-budget:]]
    out = bytearray()
    seen = set()
    for s in chosen:
        if s in seen:
            continue
        seen.add(s)
        out += s
        if len(out) >= size:
            break
    return bytes(out[-size:]) if len(out) > size else bytes(out)


def train_dictionary(samples: Iterable[bytes], size: Optional[int] = None) -> bytes:
    """Train a dictionary from sample buffers; reusable by zlib/lz4/zstd."""
    samples = [bytes(s) for s in samples if len(s) > 8]
    if not samples:
        return b""
    size = size or suggest_dict_size(samples)
    if len(samples) < 8:
        # too small a corpus for any trainer; raw-content prefix
        return b"".join(samples)[:size]
    if HAVE_ZSTD:  # pragma: no cover - not available offline
        try:
            return _zstd.train_dictionary(size, samples).as_bytes()
        except _zstd.ZstdError:
            pass
    return train_dictionary_numpy(samples, size)

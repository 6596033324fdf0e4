"""Codec policy: per-branch (algo, level, preconditioner) selection.

The paper's closing argument (§3): production and analysis want different
codecs, and "improvements are needed to the I/O APIs to ease the switch
between compression algorithms and settings for different use cases".  This
module is that API.

Two layers:

* **Profiles** — named operating points matching the paper's use cases:
    - ``production``: ratio-bound, CPU-rich  -> zstd high / lzma
    - ``analysis``:  decompression-speed-bound -> lz4 (+preconditioner)
    - ``checkpoint``: balanced, write-often read-rarely -> zstd mid
    - ``wire``: lowest latency (collectives / RPC) -> zstd-fast
* **Type heuristics** — per-branch preconditioner choice from dtype/shape,
  encoding the paper's Fig. 6 insight:
    - integer monotone-ish columns (offset arrays!) -> delta + shuffle
    - other integer columns -> shuffle
    - float/bfloat columns -> bitshuffle (exponent bits cluster)
    - opaque bytes -> none

``choose(name, arr, profile)`` returns a ready CompressionConfig and is the
single hook the checkpointer and the data pipeline use.
"""

from __future__ import annotations

import numpy as np

from .codec import CompressionConfig, HAVE_ZSTD

__all__ = ["PROFILES", "choose", "precond_for_array"]

_Z = "zstd" if HAVE_ZSTD else "zlib"

PROFILES: dict[str, dict] = {
    # algo/level pairs per the paper's operating points
    "production": {"algo": _Z, "level": 8},
    "analysis": {"algo": "lz4", "level": 1},
    "analysis-hc": {"algo": "lz4", "level": 6},
    "checkpoint": {"algo": _Z, "level": 4},
    "wire": {"algo": ("zstd-fast" if HAVE_ZSTD else "zlib"), "level": 3 if HAVE_ZSTD else 1},
    "archive": {"algo": "lzma", "level": 6},
    "off": {"algo": "none", "level": 0},
}


_OFFSET_WINDOWS = 8
_OFFSET_WINDOW_ELEMS = 512


def _is_offset_like(arr: np.ndarray) -> bool:
    """Detect offset-array-shaped data: integer, 1-D-ish, mostly monotone.

    Sampled over stratified windows spanning the *whole* array, not just
    its head: an array with a monotone prefix but a non-monotone tail
    (appended columns, mixed-phase files) must not be mistaken for an
    offset array — delta coding the shuffled tail would hurt both ratio
    and speed.  Monotonicity is judged within each window (no diff across
    window joins), then averaged.
    """
    if arr.ndim == 0 or arr.size < 16:
        return False
    flat = arr.reshape(-1)
    w = _OFFSET_WINDOW_ELEMS
    if flat.size <= _OFFSET_WINDOWS * w:
        windows = [flat]
    else:
        span = flat.size - w
        starts = [span * i // (_OFFSET_WINDOWS - 1)
                  for i in range(_OFFSET_WINDOWS)]
        windows = [flat[s:s + w] for s in starts]
    fracs = [float((np.diff(win.astype(np.int64)) >= 0).mean())
             for win in windows if win.size >= 2]
    return bool(fracs and np.mean(fracs) > 0.95)


def precond_for_array(arr: np.ndarray) -> str:
    """Paper-Fig.6 heuristic: pick the preconditioner from the dtype."""
    dt = arr.dtype
    if dt.kind in "iu":
        item = min(dt.itemsize, 8)
        if _is_offset_like(arr):
            return f"delta{item}+shuffle{item}"
        return f"shuffle{item}"
    if dt.kind == "f" or dt.name in ("bfloat16",):
        return f"bitshuffle{max(dt.itemsize, 2)}"
    if dt.kind == "V" and dt.itemsize == 2:  # bf16 often views as void16
        return "bitshuffle2"
    return "none"


def choose(name: str, arr: np.ndarray, profile: str = "checkpoint",
           dictionary: bytes | None = None) -> CompressionConfig:
    """The per-branch policy: profile picks (algo, level); dtype picks precond.

    This is the *zero-measurement* path; ``repro_torch.tune.Tuner`` runs the same
    selection from live measurements and falls back here for branches too
    small to sample.
    """
    try:
        p = PROFILES[profile]
    except KeyError:
        raise ValueError(
            f"unknown profile {profile!r}; valid profiles: "
            f"{', '.join(sorted(PROFILES))}") from None
    if p["algo"] == "none":
        return CompressionConfig(algo="none", level=0, precond="none")
    return CompressionConfig(
        algo=p["algo"], level=p["level"],
        precond=precond_for_array(np.asarray(arr)),
        dictionary=dictionary,
    )

"""Process-wide metrics registry: counters, gauges, log2-bucket histograms.

The paper's survey method is measurement — per-algorithm rates and ratios
drive every recommendation — and this module is that method turned into a
permanent runtime fixture.  Design constraints, in order:

* **lock-cheap hot path** — there is no registry-wide lock on the update
  path.  Instrument lookup is one GIL-atomic ``dict.get`` (creation takes
  the registry lock once per key); each instrument owns a tiny lock
  guarding only its own few fields, held for an add or a bucket bump.
  Disabled (``REPRO_OBS=off``) call sites get a shared no-op instrument,
  so the off path is one flag check and an attribute call.

* **mergeable snapshots** — :meth:`Registry.snapshot` is a plain JSON-able
  dict and :meth:`Registry.merge` folds one into another (counters and
  histogram buckets add, gauges last-write-win).  ``snapshot(reset=True)``
  returns a *delta* and zeroes the source, which is what makes folding
  idempotent: process-pool and shm workers snapshot-and-reset their own
  registries and the parent merges the deltas (``CompressionEngine``
  does this on close), so a worker polled twice contributes each event
  exactly once.

* **fixed log2 buckets** — histograms have 96 immutable buckets at
  power-of-two boundaries covering ``[2^-32, 2^63)`` (bucket 0 catches
  zero/underflow, bucket 95 overflow).  One layout for every unit —
  seconds, bytes, basket counts — so snapshots merge without bucket
  negotiation and quantiles come straight from the cumulative counts.
  Each bucket also accumulates the *sum of observed values* ("bsums"),
  so quantile estimates report the bucket's true mean instead of a
  positional guess — exact when a bucket holds one repeated value
  (e.g. every request took 2.0s: p99 is 2.0, not an interpolated 3.1).

* **exemplars** — when a trace context (:mod:`repro_torch.obs.context`) is
  active at ``observe()`` time, the histogram remembers the most recent
  ``(trace_id, span_id, value)`` per bucket.  A p99 read in ``obstat``
  can then name a *concrete slow trace* to go look at, not just a
  latency number.

Keys are canonical strings ``name{k=v,...}`` with sorted label keys
(:func:`format_key` / :func:`parse_key`), so a snapshot serialized as
canonical JSON has exactly one byte encoding — the property the RBSP
``STATS`` verb relies on.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Optional

from repro_torch.obs import context as _context

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "NULL",
    "format_key", "parse_key", "bucket_index", "bucket_bounds",
    "quantile_from_buckets", "exemplar_for_quantile",
    "enabled", "set_enabled",
]

_OFF_VALUES = {"off", "0", "false", "no", "disabled"}


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "on").strip().lower() not in _OFF_VALUES


_enabled = _env_enabled()


def enabled() -> bool:
    """Whether observability is on (default; ``REPRO_OBS=off`` disables)."""
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Runtime toggle (tests, the overhead A/B benchmark).  Call sites
    acquire instruments per event, so the toggle applies immediately;
    returns the previous state."""
    global _enabled
    prev, _enabled = _enabled, bool(flag)
    return prev


# ---------------------------------------------------------------------------
# key encoding
# ---------------------------------------------------------------------------

def format_key(name: str, labels: Optional[dict] = None) -> str:
    """Canonical ``name{k=v,...}`` key (sorted label keys, str values)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_key(key: str) -> tuple[str, dict]:
    """Inverse of :func:`format_key` (labels as a plain str->str dict)."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key[:-1].partition("{")
    labels = {}
    for part in inner.split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


# ---------------------------------------------------------------------------
# histogram bucket layout (fixed: merge needs one layout everywhere)
# ---------------------------------------------------------------------------

N_BUCKETS = 96
_EXP_OFFSET = 32        # bucket i covers [2^(i-33), 2^(i-32)); bucket 0 = underflow


def bucket_index(value: float) -> int:
    """The log2 bucket for ``value``: 0 for ``value < 2^-32`` (incl. 0 and
    negatives), 95 for ``value >= 2^63``."""
    if value <= 0.0:
        return 0
    e = math.frexp(value)[1] + _EXP_OFFSET    # 2^(e-1) <= v < 2^e  ->  e
    if e < 0:
        return 0
    return e if e < N_BUCKETS else N_BUCKETS - 1


def bucket_bounds(i: int) -> tuple[float, float]:
    """``[lo, hi)`` covered by bucket ``i`` (bucket 0's lo is 0)."""
    lo = 0.0 if i == 0 else 2.0 ** (i - 1 - _EXP_OFFSET)
    hi = 2.0 ** (i - _EXP_OFFSET)
    return lo, hi


def quantile_from_buckets(buckets: dict, q: float,
                          bsums: Optional[dict] = None) -> float:
    """Estimate the ``q``-quantile from ``{bucket_index: count}`` (string
    or int indices — snapshots carry strings).  0.0 for an empty histogram.

    With ``bsums`` (``{bucket_index: sum_of_values}``, the snapshot's
    ``"bsums"`` key) the selected bucket reports its observed mean,
    clamped to the bucket bounds — *exact* when the bucket holds one
    repeated value, which is what happens at bucket edges (a stream of
    identical 2.0s observations lands entirely in ``[2, 4)`` and
    positional interpolation would report up to 2x high).  Without
    ``bsums`` (older snapshots) it falls back to linear interpolation
    inside the bucket."""
    items = sorted((int(k), int(v)) for k, v in buckets.items() if int(v))
    total = sum(v for _k, v in items)
    if not total:
        return 0.0
    target = max(min(q, 1.0), 0.0) * total
    seen = 0
    for i, n in items:
        if seen + n >= target:
            lo, hi = bucket_bounds(i)
            if bsums is not None:
                s = bsums.get(str(i), bsums.get(i))
                if s is not None:
                    return min(max(float(s) / n, lo), hi)
            frac = (target - seen) / n
            return lo + (hi - lo) * frac
        seen += n
    return bucket_bounds(items[-1][0])[1]


def exemplar_for_quantile(hist_snap: dict, q: float) -> Optional[dict]:
    """The exemplar attached to the bucket containing the ``q``-quantile
    of a histogram *snapshot* (``{"buckets", "exemplars", ...}``), or
    None — the hook that links "p99 is slow" to a concrete trace_id."""
    exemplars = hist_snap.get("exemplars") or {}
    if not exemplars:
        return None
    buckets = hist_snap.get("buckets") or {}
    items = sorted((int(k), int(v)) for k, v in buckets.items() if int(v))
    total = sum(v for _k, v in items)
    if not total:
        return None
    target = max(min(q, 1.0), 0.0) * total
    seen = 0
    pick = items[-1][0]
    for i, n in items:
        if seen + n >= target:
            pick = i
            break
        seen += n
    # walk down from the selected bucket: the nearest annotated bucket at
    # or below the quantile is still a representative slow/fast sample
    for i in range(pick, -1, -1):
        ex = exemplars.get(str(i), exemplars.get(i))
        if ex is not None:
            return ex
    return None


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic count (events, bytes).  ``inc``/``add`` under a per-metric
    lock — no registry involvement on the hot path."""

    __slots__ = ("key", "_lock", "_value")
    kind = "counters"

    def __init__(self, key: str):
        self.key = key
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    add = inc

    @property
    def value(self):
        return self._value

    def _snap(self, reset: bool):
        with self._lock:
            v = self._value
            if reset:
                self._value = 0
        return v

    def _merge(self, v) -> None:
        with self._lock:
            self._value += v


class Gauge:
    """Point-in-time level (queue depth, bytes resident)."""

    __slots__ = ("key", "_lock", "_value")
    kind = "gauges"

    def __init__(self, key: str):
        self.key = key
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v          # single store: GIL-atomic

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def _snap(self, reset: bool):
        return self._value       # gauges are levels: reset keeps them

    def _merge(self, v) -> None:
        self._value = v          # last writer wins (child is fresher)


class _Timer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h):
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._h.observe(time.perf_counter() - self._t0)


class Histogram:
    """Fixed log2-bucket distribution (see module docstring).

    ``observe(v)`` is one bucket bump + per-bucket/total sums under the
    per-metric lock; ``time()`` is a context manager observing elapsed
    seconds.  With an active trace context the observed value's bucket
    also records a ``{trace_id, span_id, value}`` exemplar (last writer
    wins — the freshest sample is the one worth chasing)."""

    __slots__ = ("key", "_lock", "_buckets", "_bsums", "_count", "_sum",
                 "_exemplars")
    kind = "hists"

    def __init__(self, key: str):
        self.key = key
        self._lock = threading.Lock()
        self._buckets = [0] * N_BUCKETS
        self._bsums = [0.0] * N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._exemplars: dict[int, dict] = {}

    def observe(self, value: float) -> None:
        i = bucket_index(value)
        # inlined _context.current(): observe is the hottest instrument
        # call and the no-context probe must stay near-free
        s = _context._tls.stack
        ctx = s[-1] if s else None
        with self._lock:
            self._buckets[i] += 1
            self._bsums[i] += value
            self._count += 1
            self._sum += value
            if ctx is not None:
                self._exemplars[i] = {"trace_id": ctx.trace_id,
                                      "span_id": ctx.span_id,
                                      "value": value}

    def time(self) -> _Timer:
        return _Timer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        with self._lock:
            b = {i: n for i, n in enumerate(self._buckets) if n}
            s = {i: v for i, v in enumerate(self._bsums) if self._buckets[i]}
        return quantile_from_buckets(b, q, s)

    def _snap(self, reset: bool):
        with self._lock:
            d = {"count": self._count, "sum": self._sum,
                 "buckets": {str(i): n for i, n in enumerate(self._buckets)
                             if n},
                 "bsums": {str(i): s for i, s in enumerate(self._bsums)
                           if self._buckets[i]}}
            if self._exemplars:
                d["exemplars"] = {str(i): dict(ex)
                                  for i, ex in self._exemplars.items()}
            if reset:
                self._buckets = [0] * N_BUCKETS
                self._bsums = [0.0] * N_BUCKETS
                self._count = 0
                self._sum = 0.0
                self._exemplars = {}
        return d

    def _merge(self, d) -> None:
        with self._lock:
            self._count += int(d.get("count", 0))
            self._sum += float(d.get("sum", 0.0))
            for k, n in d.get("buckets", {}).items():
                self._buckets[int(k)] += int(n)
            for k, s in d.get("bsums", {}).items():
                self._bsums[int(k)] += float(s)
            for k, ex in d.get("exemplars", {}).items():
                if isinstance(ex, dict):
                    self._exemplars[int(k)] = dict(ex)


class _Null:
    """Shared no-op instrument: the entire cost of ``REPRO_OBS=off``."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0

    def inc(self, n=1):
        pass

    add = inc
    dec = inc

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return 0.0

    def time(self):
        return _NULL_TIMER


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


NULL = _Null()
_NULL_TIMER = _NullTimer()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class Registry:
    """One process's metric namespace (module-level :data:`REGISTRY` is the
    default; tests may instantiate their own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, labels: Optional[dict]):
        key = format_key(name, labels)
        m = self._metrics.get(key)          # GIL-atomic read, no lock
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(key)
                    self._metrics[key] = m
        if type(m) is not cls:
            raise TypeError(f"{key!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def get(self, key: str):
        """The instrument registered under a canonical key, or None."""
        return self._metrics.get(key)

    # -- snapshots -------------------------------------------------------

    def snapshot(self, reset: bool = False) -> dict:
        """JSON-able ``{"counters": {...}, "gauges": {...}, "hists": {...}}``.
        ``reset=True`` zeroes counters/histograms after reading (delta
        snapshots — the child-process folding protocol)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: dict = {"counters": {}, "gauges": {}, "hists": {}}
        for m in metrics:
            out[m.kind][m.key] = m._snap(reset)
        return out

    def merge(self, snap: dict) -> None:
        """Fold a snapshot (typically a worker's reset-delta) into this
        registry: counters and histogram buckets add, gauges last-write."""
        for kind, cls in (("counters", Counter), ("gauges", Gauge),
                          ("hists", Histogram)):
            for key, val in (snap.get(kind) or {}).items():
                name, labels = parse_key(key)
                self._get(cls, name, labels)._merge(val)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def render(self, snap: Optional[dict] = None) -> str:
        """Human-readable dump (obstat's one-shot mode)."""
        snap = snap if snap is not None else self.snapshot()
        lines = []
        for key in sorted(snap.get("counters", {})):
            lines.append(f"{key} {snap['counters'][key]}")
        for key in sorted(snap.get("gauges", {})):
            lines.append(f"{key} {snap['gauges'][key]}")
        for key in sorted(snap.get("hists", {})):
            h = snap["hists"][key]
            n = int(h.get("count", 0))
            mean = h.get("sum", 0.0) / n if n else 0.0
            p50 = quantile_from_buckets(h.get("buckets", {}), 0.50,
                                        h.get("bsums"))
            p99 = quantile_from_buckets(h.get("buckets", {}), 0.99,
                                        h.get("bsums"))
            lines.append(f"{key} count={n} mean={mean:.6g} "
                         f"p50={p50:.6g} p99={p99:.6g}")
        return "\n".join(lines)


REGISTRY = Registry()

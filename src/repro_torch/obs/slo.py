"""Rolling-window SLOs over the server's request telemetry.

An :class:`SLOSpec` states an objective for one RBSP verb — "readv p99
stays under 250 ms and the error rate stays inside a 1% budget over a
60 s window".  :class:`SLOEngine` evaluates specs from the *existing*
``server.requests`` / ``server.errors`` / ``server.request_s`` metrics:
the server feeds it monotonic registry snapshots (:meth:`tick`, called
lazily from the STATS path — no extra thread), the engine keeps a
bounded deque of ``(t, extract)`` ticks, and :meth:`evaluate` computes
the *window delta* between the newest tick and the oldest tick still
inside the window.  Deltas — not cumulative totals — are what make the
verdict a rolling view: an error storm an hour ago stops burning the
budget once it leaves the window.

Window semantics (DESIGN.md §16): with ticks at times ``t0 < ... < tn``,
the evaluated interval is ``[max(t0, tn - window_s), tn]`` — at least
two ticks are always retained, so a poller slower than the window still
gets verdicts over its actual poll interval (reported as ``span_s``).
p99 comes from the histogram-delta buckets with bucket-sum refinement
(:func:`repro_torch.obs.metrics.quantile_from_buckets`), so a steady latency
plateau right at a bucket edge is judged at its true value.

Results ride the STATS body (``"slo"`` key) and render in
``obstat --watch``; nothing here takes locks shared with the serving
hot path.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from repro_torch.obs import metrics as _metrics

__all__ = ["SLOSpec", "SLOEngine", "DEFAULT_SPECS"]


class SLOSpec:
    """One verb's objectives; either bound may be None (not asserted)."""

    __slots__ = ("name", "verb", "p99_s", "error_budget", "window_s")

    def __init__(self, name: str, verb: str, p99_s: Optional[float] = None,
                 error_budget: Optional[float] = 0.01,
                 window_s: float = 60.0):
        self.name = name
        self.verb = verb
        self.p99_s = p99_s
        self.error_budget = error_budget
        self.window_s = float(window_s)

    def to_dict(self) -> dict:
        return {"name": self.name, "verb": self.verb, "p99_s": self.p99_s,
                "error_budget": self.error_budget, "window_s": self.window_s}


# The loopback/LAN operating point the repo's own benches run at; a real
# deployment passes its own specs to BasketServer(slo=[...]).
DEFAULT_SPECS = [
    SLOSpec("readv-latency", "readv", p99_s=0.250),
    SLOSpec("catalog-latency", "catalog", p99_s=0.250),
]


def _hist_delta(cur: dict, old: dict) -> tuple[int, dict, dict]:
    cb, ob = cur.get("buckets", {}), old.get("buckets", {})
    buckets = {}
    for k, v in cb.items():
        d = int(v) - int(ob.get(k, 0))
        if d > 0:
            buckets[k] = d
    cs, os_ = cur.get("bsums", {}), old.get("bsums", {})
    bsums = {k: float(cs.get(k, 0.0)) - float(os_.get(k, 0.0))
             for k in buckets}
    n = int(cur.get("count", 0)) - int(old.get("count", 0))
    return n, buckets, bsums


class SLOEngine:
    """Rolling evaluation of a spec list against snapshot ticks."""

    def __init__(self, specs=None, max_ticks: int = 256):
        self.specs = list(specs) if specs is not None else list(DEFAULT_SPECS)
        self._ticks: deque = deque(maxlen=max_ticks)

    def _extract(self, snap: dict) -> dict:
        """Keep only what evaluation needs (ticks are retained by the
        dozen; shipping whole registries into the deque would bloat)."""
        verbs = {s.verb for s in self.specs}
        hists, counters = {}, {}
        for key, h in (snap.get("hists") or {}).items():
            name, labels = _metrics.parse_key(key)
            if name == "server.request_s" and labels.get("verb") in verbs:
                hists[labels["verb"]] = {
                    "count": int(h.get("count", 0)),
                    "buckets": dict(h.get("buckets", {})),
                    "bsums": dict(h.get("bsums", {}))}
        for key, v in (snap.get("counters") or {}).items():
            name, labels = _metrics.parse_key(key)
            if name in ("server.requests", "server.errors") \
                    and labels.get("verb") in verbs:
                counters[(name, labels["verb"])] = int(v)
        return {"hists": hists, "counters": counters}

    def tick(self, snap: dict, t: Optional[float] = None) -> None:
        """Record one monotonic (non-reset) snapshot observation."""
        t = time.time() if t is None else t
        if self._ticks and t <= self._ticks[-1][0]:
            return
        self._ticks.append((t, self._extract(snap)))
        self._prune(t)

    def _prune(self, now: float) -> None:
        window = max((s.window_s for s in self.specs), default=60.0)
        while len(self._ticks) > 2 and now - self._ticks[1][0] > window:
            self._ticks.popleft()

    def evaluate(self, now: Optional[float] = None) -> list[dict]:
        """Per-spec verdicts over the current window; ``[]`` until two
        ticks exist (no delta to judge)."""
        if len(self._ticks) < 2:
            return []
        now = self._ticks[-1][0] if now is None else now
        t1, cur = self._ticks[-1]
        out = []
        for spec in self.specs:
            # oldest tick still inside this spec's window (always ≥ 1 back,
            # so pollers slower than the window judge their real interval)
            in_window = [(t, e) for t, e in self._ticks
                         if t < t1 and t1 - t <= spec.window_s]
            t0, old = in_window[0] if in_window else self._ticks[-2]
            n, buckets, bsums = _hist_delta(cur["hists"].get(spec.verb, {}),
                                            old["hists"].get(spec.verb, {}))
            reqs = (cur["counters"].get(("server.requests", spec.verb), 0)
                    - old["counters"].get(("server.requests", spec.verb), 0))
            errs = (cur["counters"].get(("server.errors", spec.verb), 0)
                    - old["counters"].get(("server.errors", spec.verb), 0))
            verdict = {"name": spec.name, "verb": spec.verb,
                       "span_s": round(t1 - t0, 3), "window_s": spec.window_s,
                       "requests": max(reqs, 0), "errors": max(errs, 0),
                       "ok": True}
            if n > 0 and spec.p99_s is not None:
                p99 = _metrics.quantile_from_buckets(buckets, 0.99, bsums)
                verdict["p99_s"] = p99
                verdict["p99_limit_s"] = spec.p99_s
                if p99 > spec.p99_s:
                    verdict["ok"] = False
            if reqs > 0 and spec.error_budget is not None:
                rate = errs / reqs
                verdict["error_rate"] = rate
                verdict["error_budget"] = spec.error_budget
                verdict["burn"] = (rate / spec.error_budget
                                   if spec.error_budget > 0 else float("inf"))
                if rate > spec.error_budget:
                    verdict["ok"] = False
            out.append(verdict)
        return out

"""Persistent access-heat telemetry: the repacker's evidence base.

The server keeps in-memory ``server.reads{path,branch}`` counters;
they die with the process, and the ROADMAP's background-repacker item
needs *durable* per-branch/basket access evidence to drive tier
migration ("Optimizing ROOT IO For Analysis" makes the same point:
layout decisions follow measured access patterns, not guesses).

:class:`HeatLog` keeps, per served container, a per-branch record of

* ``reads`` / ``bytes`` — cumulative basket reads and payload bytes
  (monotonic, survive restarts: the long-term popularity signal),
* ``heat`` — a half-life-decayed EWMA of read counts
  (``heat = heat * 2^(-dt/halflife) + n``): the *recency-weighted*
  signal that distinguishes "hot this hour" from "hot last month",
* ``baskets`` — per-basket read counts, so a repacker can see *which
  region* of a branch is hot, not just that the branch is.

State is folded to a JSON sidecar ``<container>.heat`` next to the
container with the container's atomic commit idiom (spool to ``.tmp``,
``fsync`` the file, ``os.replace``, ``fsync`` the directory), so a
crash mid-flush leaves the previous sidecar intact — old-or-new, never
torn.  On first touch of a container the existing sidecar is adopted
(with its ``heat`` decayed across the downtime), so a server restart
resumes the telemetry instead of resetting it.

The server calls :meth:`record` on every READV (cheap: dict updates
under one lock) and :meth:`maybe_flush` opportunistically; STATS
exports :meth:`snapshot` on request (``{"heat": true}``); and
``tools/heatmap.py`` reads either the sidecars or the STATS view.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from repro_torch import obs

__all__ = ["HeatLog", "SIDECAR_SUFFIX", "load_sidecar", "rank_branches"]

SIDECAR_SUFFIX = ".heat"
_VERSION = 1


def _decay(heat: float, dt: float, halflife_s: float) -> float:
    if dt <= 0.0 or heat == 0.0:
        return heat
    return heat * math.pow(2.0, -dt / halflife_s)


def load_sidecar(path: str) -> Optional[dict]:
    """Parse one ``.heat`` sidecar; None if absent or unreadable (a
    corrupt sidecar must never take down the server — heat is advisory)."""
    try:
        with open(path, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("version") != _VERSION:
        return None
    if not isinstance(doc.get("branches"), dict):
        return None
    return doc


def rank_branches(doc: dict, now: Optional[float] = None) -> list[tuple]:
    """``[(branch, heat_now, reads, bytes), ...]`` hottest first, with
    each stored heat decayed to ``now``."""
    now = time.time() if now is None else now
    hl = float(doc.get("halflife_s") or 3600.0)
    rows = []
    for branch, rec in (doc.get("branches") or {}).items():
        heat = _decay(float(rec.get("heat", 0.0)),
                      now - float(rec.get("t", now)), hl)
        rows.append((branch, heat, int(rec.get("reads", 0)),
                     int(rec.get("bytes", 0))))
    rows.sort(key=lambda r: (-r[1], -r[2], r[0]))
    return rows


class HeatLog:
    """In-memory heat state for every container a server touches, with
    periodic durable folding to per-container sidecars."""

    def __init__(self, halflife_s: float = 3600.0,
                 flush_interval_s: float = 30.0,
                 max_baskets_per_branch: int = 4096):
        self.halflife_s = float(halflife_s)
        self.flush_interval_s = float(flush_interval_s)
        self.max_baskets_per_branch = int(max_baskets_per_branch)
        self._lock = threading.Lock()
        # abspath -> {"branches": {...}, "dirty": bool, "flushed_t": float}
        self._state: dict[str, dict] = {}

    # -- recording -------------------------------------------------------

    def _load_locked(self, path: str) -> dict:
        st = self._state.get(path)
        if st is not None:
            return st
        st = {"branches": {}, "dirty": False, "flushed_t": time.time()}
        doc = load_sidecar(path + SIDECAR_SUFFIX)
        if doc is not None:
            now = time.time()
            then = float(doc.get("updated_unix", now))
            for branch, rec in doc["branches"].items():
                st["branches"][branch] = {
                    "reads": int(rec.get("reads", 0)),
                    "bytes": int(rec.get("bytes", 0)),
                    "heat": _decay(float(rec.get("heat", 0.0)),
                                   now - float(rec.get("t", then)),
                                   self.halflife_s),
                    "t": now,
                    "baskets": {str(k): int(v) for k, v in
                                (rec.get("baskets") or {}).items()},
                }
            obs.counter("obs.heat.sidecar_loads").inc()
        self._state[path] = st
        return st

    def record(self, path: str, branch: str, baskets, nbytes: int) -> None:
        """Fold one READV's worth of reads: ``baskets`` is an iterable of
        basket indices served for ``branch`` from container ``path``."""
        path = os.path.abspath(path)
        idxs = list(baskets)
        if not idxs:
            return
        now = time.time()
        with self._lock:
            st = self._load_locked(path)
            rec = st["branches"].get(branch)
            if rec is None:
                rec = st["branches"][branch] = {
                    "reads": 0, "bytes": 0, "heat": 0.0, "t": now,
                    "baskets": {}}
            rec["reads"] += len(idxs)
            rec["bytes"] += int(nbytes)
            rec["heat"] = _decay(rec["heat"], now - rec["t"],
                                 self.halflife_s) + len(idxs)
            rec["t"] = now
            bk = rec["baskets"]
            for i in idxs:
                k = str(int(i))
                if k in bk or len(bk) < self.max_baskets_per_branch:
                    bk[k] = bk.get(k, 0) + 1
            st["dirty"] = True

    # -- durability ------------------------------------------------------

    def _commit(self, path: str, branches: dict) -> None:
        from repro_torch.core.bfile import _fsync_dir
        sidecar = path + SIDECAR_SUFFIX
        doc = {"version": _VERSION, "halflife_s": self.halflife_s,
               "updated_unix": time.time(), "container": os.path.basename(path),
               "branches": branches}
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, sidecar)
        _fsync_dir(os.path.dirname(os.path.abspath(sidecar)))
        obs.counter("obs.heat.flushes").inc()

    def flush(self, path: Optional[str] = None) -> int:
        """Commit dirty state (one container, or all) to sidecars now;
        returns the number of sidecars written.  Flush failures (read-only
        media, deleted container dir) are swallowed after counting —
        telemetry must never break serving."""
        with self._lock:
            if path is not None:
                paths = [os.path.abspath(path)]
            else:
                paths = list(self._state)
            work = []
            for p in paths:
                st = self._state.get(p)
                if st is None or not st["dirty"]:
                    continue
                work.append((p, json.loads(json.dumps(st["branches"]))))
                st["dirty"] = False
                st["flushed_t"] = time.time()
        n = 0
        for p, branches in work:
            try:
                self._commit(p, branches)
                n += 1
            except OSError:
                obs.counter("obs.heat.flush_errors").inc()
        return n

    def maybe_flush(self) -> int:
        """Flush containers whose last durable fold is older than the
        flush interval (the server calls this from its request loop)."""
        now = time.time()
        with self._lock:
            due = [p for p, st in self._state.items()
                   if st["dirty"] and
                   now - st["flushed_t"] >= self.flush_interval_s]
        n = 0
        for p in due:
            n += self.flush(p)
        return n

    # -- export ----------------------------------------------------------

    def snapshot(self, top_baskets: int = 8) -> dict:
        """JSON-able view for STATS: per container (abspath), per branch
        aggregates plus the ``top_baskets`` hottest basket indices."""
        now = time.time()
        out: dict = {}
        with self._lock:
            for path, st in self._state.items():
                branches = {}
                for branch, rec in st["branches"].items():
                    hot = sorted(rec["baskets"].items(),
                                 key=lambda kv: (-kv[1], int(kv[0])))
                    branches[branch] = {
                        "reads": rec["reads"], "bytes": rec["bytes"],
                        "heat": _decay(rec["heat"], now - rec["t"],
                                       self.halflife_s),
                        "baskets_hot": dict(hot[:top_baskets]),
                    }
                out[path] = {"halflife_s": self.halflife_s,
                             "branches": branches}
        return out

"""Background scrubbing — find latent rot before a reader does.

:func:`scrub_container` walks every basket of one container through the
``repro_torch.io.fdcache`` pread path (so the disk-rot fault hook
exercises exactly what production reads exercise), decode-verifies each
against its stored adler32, and — when the container has a parity
sidecar — heals damage in place via ``BasketFile(heal="auto")``.

Two production concerns shape the API:

* **Byte-rate budget** (``mbps``): a scrubber shares spindles with live
  traffic, so it paces itself — after each basket it sleeps whatever
  keeps cumulative ``bytes / elapsed`` at or under the budget.  The
  budget counts *compressed* bytes read, which is what the device sees.

* **Resumable cursor** (``resume=True``): progress persists to a
  ``<container>.scrub`` sidecar (atomic tmp+replace, stamped with the
  container's content stamp) every few baskets, so a restarted process
  continues where the last one stopped instead of re-verifying from
  byte 0 — on a petabyte fleet a scrub pass takes days and restarts are
  routine.  A cursor stamped for different container content (the file
  was rewritten) is discarded.

:class:`Scrubber` is the server-side wrapper: a low-priority daemon
thread sweeping every ``*.bskt`` under a root, with ``status()`` /
``trigger()`` / ``scrub_now()`` hooks the RBSP ``SCRUB`` verb exposes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from repro_torch.core.bfile import BasketFile, CorruptBasketError, \
    TruncatedContainerError

__all__ = ["scrub_container", "cursor_path", "Scrubber"]

MB = 1 << 20
_CURSOR_EVERY = 16          # baskets between cursor persists


def cursor_path(container_path: str) -> str:
    return str(container_path) + ".scrub"


def _counter(name: str, n: int = 1) -> None:
    try:
        from repro_torch import obs
        obs.counter(name).inc(n)
    except Exception:
        pass


def _load_cursor(path: str, stamp: dict) -> Optional[tuple[str, int]]:
    """The persisted ``(branch, next_index)`` position, or ``None`` for a
    missing/undecodable cursor or one stamped for different content."""
    try:
        with open(cursor_path(path)) as f:
            cur = json.load(f)
    except (OSError, ValueError):
        return None
    if cur.get("stamp") != stamp or cur.get("done"):
        return None
    br, idx = cur.get("branch"), cur.get("index")
    if not isinstance(br, str) or not isinstance(idx, int):
        return None
    return br, idx


def _save_cursor(path: str, stamp: dict, branch: Optional[str], index: int,
                 done: bool = False) -> None:
    cpath = cursor_path(path)
    tmp = cpath + ".tmp"
    doc = {"stamp": stamp, "branch": branch, "index": int(index),
           "done": bool(done), "saved_at": time.time()}
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, cpath)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def scrub_container(path: str, *, heal: bool = True,
                    mbps: Optional[float] = None, resume: bool = True,
                    max_baskets: Optional[int] = None) -> dict:
    """Verify (and optionally heal) every basket of one container.

    Returns a report::

        {"path", "baskets", "bytes", "corrupt", "healed",
         "unhealable": [[branch, index], ...], "resumed", "completed"}

    ``corrupt`` counts baskets whose first verified read failed (the
    damage the scrub *found*); ``healed`` counts those repaired in place
    from parity.  ``max_baskets`` stops early (cursor persisted, resumable
    — also how the restart test simulates a killed scrubber).  A torn
    container (unreadable TOC) is reported, not raised::

        {"path", "error": "...", "completed": False, ...}
    """
    path = str(path)
    report = {"path": path, "baskets": 0, "bytes": 0, "corrupt": 0,
              "healed": 0, "unhealable": [], "resumed": False,
              "completed": False}
    try:
        bf = BasketFile(path, heal="auto" if heal else None)
    except (TruncatedContainerError, ValueError, OSError) as e:
        report["error"] = str(e)
        return report
    t0 = time.monotonic()
    stopped = False
    with bf:
        stamp = bf._content_stamp
        names = sorted(bf.branch_names())
        start = _load_cursor(path, stamp) if resume else None
        if start is not None:
            report["resumed"] = True
        skipping = start is not None
        since_save = 0
        for name in names:
            if skipping and name != start[0]:
                continue
            baskets = bf.branches[name]["baskets"]
            first = 0
            if skipping:
                first, skipping = start[1], False
            for i in range(first, len(baskets)):
                if max_baskets is not None and \
                        report["baskets"] >= max_baskets:
                    stopped = True
                    break
                comp_len = int(baskets[i]["meta"]["comp_len"])
                healed_before = bf.heal_stats["healed"]
                ok_first = bf._try_decode(name, i) is not None
                if not ok_first:
                    report["corrupt"] += 1
                    _counter("repair.scrub.corrupt")
                    if heal:
                        try:
                            bf._heal_basket(name, i)
                        except CorruptBasketError:
                            report["unhealable"].append([name, i])
                    else:
                        report["unhealable"].append([name, i])
                report["healed"] += bf.heal_stats["healed"] - healed_before
                report["baskets"] += 1
                report["bytes"] += comp_len
                _counter("repair.scrub.baskets")
                _counter("repair.scrub.bytes", comp_len)
                since_save += 1
                if since_save >= _CURSOR_EVERY:
                    _save_cursor(path, stamp, name, i + 1)
                    since_save = 0
                if mbps:
                    # pace: sleep until cumulative rate is back under budget
                    ahead = report["bytes"] / (mbps * MB) \
                        - (time.monotonic() - t0)
                    if ahead > 0:
                        time.sleep(min(ahead, 0.5))
            if stopped:
                # persist exactly where the next run must resume (basket
                # ``i`` was not processed — the break precedes the read)
                _save_cursor(path, stamp, name, i)
                break
        if not stopped:
            _save_cursor(path, stamp, None, 0, done=True)
            report["completed"] = True
    report["healed_total"] = report["healed"]
    _counter("repair.scrub.healed", report["healed"])
    return report


class Scrubber:
    """The server's background scrub loop (one daemon thread).

    Sweeps every ``*.bskt`` under ``root`` at the byte-rate budget,
    then sleeps ``interval`` seconds and sweeps again.  Low priority by
    construction: the budget paces disk reads, and each basket holds the
    heal lock only as long as a foreground heal would.  ``trigger()``
    wakes the loop immediately (the RBSP SCRUB verb); ``status()`` is a
    JSON-safe snapshot; ``scrub_now()`` runs synchronously on the
    caller's thread (the one-shot CLI / test path)."""

    def __init__(self, root: str, *, mbps: Optional[float] = None,
                 heal: bool = True, interval: float = 30.0):
        self.root = os.path.abspath(root)
        self.mbps = mbps
        self.heal = heal
        self.interval = float(interval)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._state = {"sweeps": 0, "containers": 0, "baskets": 0,
                       "bytes": 0, "corrupt": 0, "healed": 0,
                       "unhealable": 0, "running": False, "current": None}
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-scrubber", daemon=True)
        self._thread.start()

    def _containers(self) -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in sorted(files):
                if fn.endswith(".bskt"):
                    out.append(os.path.join(dirpath, fn))
        return sorted(out)

    def _sweep(self) -> None:
        for cpath in self._containers():
            if self._stop.is_set():
                return
            with self._lock:
                self._state["current"] = os.path.relpath(cpath, self.root)
            rep = scrub_container(cpath, heal=self.heal, mbps=self.mbps)
            with self._lock:
                self._state["containers"] += 1
                for k in ("baskets", "bytes", "corrupt", "healed"):
                    self._state[k] += rep.get(k, 0)
                self._state["unhealable"] += len(rep.get("unhealable", []))
        with self._lock:
            self._state["sweeps"] += 1
            self._state["current"] = None

    def _loop(self) -> None:
        with self._lock:
            self._state["running"] = True
        while not self._stop.is_set():
            try:
                self._sweep()
            except Exception:
                pass                 # a scrub crash must never kill a server
            self._wake.wait(self.interval)
            self._wake.clear()
        with self._lock:
            self._state["running"] = False

    def trigger(self) -> None:
        """Start the next sweep now instead of after ``interval``."""
        self._wake.set()

    def scrub_now(self, path: Optional[str] = None) -> list[dict]:
        """Synchronous scrub of one container (path relative to root) or
        every container — the SCRUB verb's ``sync`` action."""
        if path is not None:
            return [scrub_container(os.path.join(self.root, path),
                                    heal=self.heal, mbps=self.mbps)]
        return [scrub_container(c, heal=self.heal, mbps=self.mbps)
                for c in self._containers()]

    def status(self) -> dict:
        with self._lock:
            return dict(self._state)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)

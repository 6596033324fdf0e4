"""Tiered client-side basket cache: decoded-bytes LRU + wire-payload spill.

The TTreeCache lesson applied to a networked reader: the expensive things,
in order, are (1) the round-trip, (2) the decode, (3) local disk.  So the
cache has two byte-budgeted tiers:

* **memory** — decoded (raw) basket bytes, LRU.  A hit costs a dict
  lookup; re-reads (epoch loops, overlapping entry ranges) are free.
* **disk** — *wire* payloads (still compressed, with their metadata), LRU
  with files spilled under a cache directory.  A hit costs a local read +
  decode but no round-trip; the tier is what makes a cold re-open of a
  recently-read remote file cheap.

Keys are ``(path, generation, branch, index)`` where ``path`` includes
the serving endpoint (``host:port/rel-path`` — two servers exporting
same-named files must never share entries) and ``generation`` is the
server-reported ``(st_dev, st_ino)`` of the container — the same key
``repro_torch.io.fdcache`` revalidates local reads with — so a file replaced on
the server can never serve stale cached baskets: its new catalog carries
a new generation and misses cleanly.

Thread-safe; one cache may back many ``RemoteBasketFile``s.  Disk spill
can be fed asynchronously (:meth:`put_wire_async`): the hot read path
enqueues and a background writer does the file I/O, dropping entries
rather than stalling when the disk can't keep up — the cache is
advisory, the socket pipeline is not.
"""

from __future__ import annotations

import hashlib
import os
import queue
import shutil
import tempfile
import threading
from collections import OrderedDict
from typing import Optional

from repro_torch import obs

__all__ = ["TieredCache", "basket_key"]


def basket_key(path: str, generation, branch: str, index: int) -> tuple:
    """The canonical cache key for one basket of one file generation."""
    gen = tuple(generation) if generation is not None else None
    return (str(path), gen, str(branch), int(index))


class TieredCache:
    """Byte-budgeted two-tier basket cache (see module docstring).

    ``mem_bytes=0`` disables the decoded tier, ``disk_bytes=0`` the spill
    tier.  ``disk_dir=None`` creates (and owns) a temporary directory,
    removed on :meth:`close`."""

    def __init__(self, mem_bytes: int = 64 << 20, disk_bytes: int = 0,
                 disk_dir: Optional[str] = None):
        self.mem_bytes = max(int(mem_bytes), 0)
        self.disk_bytes = max(int(disk_bytes), 0)
        self._lock = threading.Lock()
        self._mem: OrderedDict[tuple, bytes] = OrderedDict()
        self._mem_used = 0
        self._disk: OrderedDict[tuple, tuple[str, int, dict]] = OrderedDict()
        self._disk_used = 0
        self._owns_dir = False
        self._dir = None
        self._spillq: Optional[queue.Queue] = None
        self._spiller: Optional[threading.Thread] = None
        if self.disk_bytes:
            if disk_dir is None:
                self._dir = tempfile.mkdtemp(prefix="repro-bcache-")
                self._owns_dir = True
            else:
                self._dir = str(disk_dir)
                os.makedirs(self._dir, exist_ok=True)
        # stats: the per-instance ints below are canonical (stats() reads
        # them under the lock); the obs registry carries the process-wide
        # mirror, bumped per event outside the lock
        self.mem_hits = 0
        self.disk_hits = 0
        self.misses = 0

    # -- decoded tier ----------------------------------------------------

    def get_decoded(self, key: tuple) -> Optional[bytes]:
        with self._lock:
            raw = self._mem.get(key)
            if raw is not None:
                self._mem.move_to_end(key)
                self.mem_hits += 1
        if raw is not None:
            obs.counter("client.cache", tier="mem", event="hit").inc()
            return raw
        return None

    def put_decoded(self, key: tuple, raw: bytes) -> None:
        raw = bytes(raw)
        if not self.mem_bytes or len(raw) > self.mem_bytes:
            return
        evicted = 0
        with self._lock:
            old = self._mem.pop(key, None)
            if old is not None:
                self._mem_used -= len(old)
            self._mem[key] = raw
            self._mem_used += len(raw)
            while self._mem_used > self.mem_bytes and self._mem:
                _k, v = self._mem.popitem(last=False)
                self._mem_used -= len(v)
                evicted += 1
            used = self._mem_used
        if evicted:
            obs.counter("client.cache", tier="mem", event="evict").inc(evicted)
        obs.gauge("client.cache_used", tier="mem").set(used)

    # -- wire tier -------------------------------------------------------

    def _fname(self, key: tuple) -> str:
        h = hashlib.sha1(repr(key).encode()).hexdigest()
        return os.path.join(self._dir, h + ".wire")

    def get_wire(self, key: tuple) -> Optional[tuple[bytes, dict]]:
        """The spilled ``(wire_payload, meta_json)`` for ``key``; None on
        miss (including a cache file deleted underneath us)."""
        with self._lock:
            rec = self._disk.get(key)
            if rec is None:
                return None
            self._disk.move_to_end(key)
            fname, _size, meta = rec
        try:
            with open(fname, "rb") as f:
                payload = f.read()
        except OSError:
            with self._lock:
                r = self._disk.pop(key, None)
                if r is not None:
                    self._disk_used -= r[1]
            return None
        with self._lock:
            self.disk_hits += 1
        obs.counter("client.cache", tier="disk", event="hit").inc()
        return payload, dict(meta)

    def put_wire(self, key: tuple, payload, meta_json: dict) -> None:
        if not self.disk_bytes:
            return
        payload = bytes(payload)
        if len(payload) > self.disk_bytes:
            return
        fname = self._fname(key)
        tmp = fname + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, fname)
        except OSError:
            return                      # a full cache disk is not an error
        evict = []
        with self._lock:
            old = self._disk.pop(key, None)
            if old is not None:
                self._disk_used -= old[1]
            self._disk[key] = (fname, len(payload), dict(meta_json))
            self._disk_used += len(payload)
            while self._disk_used > self.disk_bytes and self._disk:
                _k, (fn, sz, _m) = self._disk.popitem(last=False)
                self._disk_used -= sz
                evict.append(fn)
            used = self._disk_used
        if evict:
            obs.counter("client.cache", tier="disk",
                        event="evict").inc(len(evict))
        obs.gauge("client.cache_used", tier="disk").set(used)
        for fn in evict:
            try:
                os.remove(fn)
            except OSError:
                pass

    def put_wire_async(self, key: tuple, payload, meta_json: dict) -> None:
        """Queue a spill write for the background writer.  Non-blocking:
        when the queue is full the entry is dropped (advisory cache) so a
        slow disk can never stall the caller's socket pipeline."""
        if not self.disk_bytes:
            return
        with self._lock:
            if self._spillq is None:
                self._spillq = queue.Queue(maxsize=64)
                self._spiller = threading.Thread(
                    target=self._spill_loop, daemon=True,
                    name="repro-bcache-spill")
                self._spiller.start()
            q = self._spillq
        try:
            q.put_nowait((key, bytes(payload), dict(meta_json)))
        except queue.Full:
            pass

    def _spill_loop(self) -> None:
        q = self._spillq                # close() nulls the attribute
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                self.put_wire(*item)
            finally:
                q.task_done()

    def flush(self) -> None:
        """Block until queued async spills hit the disk tier (tests and
        deterministic shutdowns)."""
        with self._lock:
            q = self._spillq
        if q is not None:
            q.join()

    def drop(self, key: tuple) -> None:
        """Remove ``key`` from both tiers — the corrupt-basket quarantine
        path: a cached payload that failed its content checksum must not
        be served again."""
        fn = None
        with self._lock:
            raw = self._mem.pop(key, None)
            if raw is not None:
                self._mem_used -= len(raw)
            rec = self._disk.pop(key, None)
            if rec is not None:
                fn, sz, _m = rec
                self._disk_used -= sz
        if fn is not None:
            try:
                os.remove(fn)
            except OSError:
                pass

    # -- bookkeeping -----------------------------------------------------

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1
        obs.counter("client.cache", event="miss").inc()

    def stats(self) -> dict:
        """Consistent snapshot: every counter and byte total is read under
        the one lock, so hits/used/items always describe the same instant."""
        with self._lock:
            return {"mem_hits": self.mem_hits, "disk_hits": self.disk_hits,
                    "misses": self.misses, "mem_used": self._mem_used,
                    "disk_used": self._disk_used,
                    "mem_items": len(self._mem),
                    "disk_items": len(self._disk)}

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._mem_used = 0
            files = [fn for fn, _sz, _m in self._disk.values()]
            self._disk.clear()
            self._disk_used = 0
        for fn in files:
            try:
                os.remove(fn)
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            q, self._spillq = self._spillq, None
            spiller, self._spiller = self._spiller, None
        if q is not None:
            q.put(None)
            spiller.join(timeout=5)
        self.clear()
        if self._owns_dir and self._dir and os.path.isdir(self._dir):
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

"""Decompress-ahead branch reader — the TTreeCache analogue.

ROOT hides decompression latency behind the analysis loop by reading and
decompressing the baskets for *upcoming* entry ranges while the current
range is being consumed ("simultaneous read and decompression for multiple
physics events", paper Fig. 1).  ``PrefetchReader`` reproduces that:

* every basket access schedules the next ``ahead`` baskets on the engine's
  worker pool, so by the time the consumer asks for basket *i+1* it is
  usually already decompressed;
* an LRU cache of decompressed baskets (``cache_baskets`` deep) makes
  re-reads — overlapping entry ranges, restart-cursor replays, epoch
  loops over small files — free;
* ``read_all`` schedules *every* basket at once and joins in order: the
  full-throughput parallel branch read.

The reader is stateless with respect to the file (it uses the offsets and
metadata captured from the TOC at construction), so many readers can share
one ``BasketFile`` and one engine.

Staleness: the source's ``(st_dev, st_ino)`` generation is captured with
the TOC and passed to every scheduled read — a container replaced under
the reader raises ``fdcache.StaleFileError`` instead of mixing cached
baskets from the old file with fresh reads of the new one.

Remote sources: any object exposing ``branches``/``_dictionary`` plus a
``submit_baskets(branch, idxs) -> list[Future[bytes]]`` method (e.g.
the reference's ``RemoteBasketFile``; ``remote`` is not ported yet,
ROADMAP A9) can sit where the local ``BasketFile`` does.  Scheduling batches every uncached index of a prefetch/acquire wave
into ONE ``submit_baskets`` call, which the remote client turns into one
vectored wire request — the read-ahead that makes a high-latency link
look local.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.basket import BasketMeta, byte_offsets

from .engine import CompressionEngine

__all__ = ["PrefetchReader"]


class PrefetchReader:
    def __init__(self, bfile, branch: str, *, workers: int = 2,
                 ahead: int = 4, cache_baskets: int = 32,
                 engine: Optional[CompressionEngine] = None,
                 verify: Optional[bool] = None):
        entry = bfile.branches[branch]
        self.path = bfile.path
        self.branch = branch
        self.dtype = np.dtype(entry["dtype"])
        self.shape = tuple(entry["shape"])
        self.verify = getattr(bfile, "verify", True) if verify is None else verify
        self._dictionary = bfile._dictionary(entry)
        self._offsets = [b["offset"] for b in entry["baskets"]]
        self._meta_json = [dict(b["meta"]) for b in entry["baskets"]]
        self._metas = [BasketMeta.from_json(m) for m in self._meta_json]
        # remote sources schedule through the source itself (one vectored
        # request per wave); local files through the engine + fdcache
        self._source = bfile if hasattr(bfile, "submit_baskets") else None
        # the generation of the file this TOC describes: every scheduled
        # read checks it, so a tmp-then-replaced container fails loudly
        # instead of serving baskets the cached metadata does not match
        self.generation = getattr(bfile, "generation", None)
        self.ahead = max(int(ahead), 0)
        self.cache_baskets = max(int(cache_baskets), 1)
        self._engine = engine or (None if self._source is not None
                                  else CompressionEngine(workers))
        self._owns_engine = engine is None and self._engine is not None
        self._lock = threading.Lock()
        self._cache: OrderedDict[int, Future] = OrderedDict()  # idx -> Future[bytes]
        self.hits = 0
        self.misses = 0

    # -- scheduling ------------------------------------------------------

    def n_baskets(self) -> int:
        return len(self._metas)

    def _submit(self, idxs: list[int]) -> list[Future]:
        """Source-side scheduling of uncached baskets, one batch."""
        if self._source is not None:
            return self._source.submit_baskets(self.branch, idxs,
                                               verify=self.verify)
        return [self._engine.submit_unpack(
            self.path, self._offsets[i], self._meta_json[i],
            self._dictionary, self.verify, self.generation) for i in idxs]

    def _schedule_many(self, idxs) -> list[Future]:
        """Ensure every index is scheduled (or cached); LRU-touch hits and
        submit the misses as ONE batch.  Call with the lock held."""
        have: dict[int, Future] = {}
        missing: list[int] = []
        for i in idxs:
            if i in have:
                continue
            fut = self._cache.get(i)
            if fut is not None:
                self._cache.move_to_end(i)
                have[i] = fut
            else:
                missing.append(i)
                have[i] = None  # placeholder: preserves dedup
        if missing:
            for i, fut in zip(missing, self._submit(missing)):
                self._cache[i] = fut
                have[i] = fut
            while len(self._cache) > self.cache_baskets:
                _old_idx, old_fut = next(iter(self._cache.items()))
                if not old_fut.done():        # never drop work still in flight
                    break
                self._cache.popitem(last=False)
        return [have[i] for i in idxs]

    def prefetch(self, indices) -> None:
        """Schedule decompression for the given basket indices."""
        with self._lock:
            self._schedule_many([i for i in indices
                                 if 0 <= i < len(self._metas)])

    def _acquire(self, indices) -> list[Future]:
        """Futures for baskets about to be *consumed*.  Holding the future
        (not the cache slot) means LRU eviction can never force a second
        decompression of work already in flight; an index already cached
        (even if still decompressing — i.e. prefetched in time) is a hit."""
        with self._lock:
            hits = 0
            for i in indices:
                cached = i in self._cache
                hits += cached
            misses = len(indices) - hits
            self.hits += hits
            self.misses += misses
            futs = self._schedule_many(indices)
        # mirror into obs as one batched add per wave, not per basket
        if hits:
            obs.counter("prefetch.requests", event="hit").inc(hits)
        if misses:
            obs.counter("prefetch.requests", event="miss").inc(misses)
        return futs

    def _trim(self) -> None:
        """Shrink the cache back to ``cache_baskets`` (oldest completed
        first) — bulk reads schedule every basket at once, and without
        this the whole decompressed branch would stay pinned until
        close()."""
        with self._lock:
            while len(self._cache) > self.cache_baskets:
                _idx, fut = next(iter(self._cache.items()))
                if not fut.done():
                    break
                self._cache.popitem(last=False)

    def basket(self, idx: int) -> bytes:
        """Decompressed bytes of basket ``idx``; schedules ``ahead`` more."""
        fut = self._acquire([idx])[0]
        self.prefetch(range(idx + 1, min(idx + 1 + self.ahead,
                                         len(self._metas))))
        return fut.result()

    # -- reads -----------------------------------------------------------

    def _covering(self, start: int, stop: int) -> list[int]:
        return [i for i, m in enumerate(self._metas)
                if m.entry_start + m.entry_count > start
                and m.entry_start < stop]

    @staticmethod
    def _scatter(flat: np.ndarray, pos: int, chunk) -> int:
        b = np.frombuffer(chunk, dtype=np.uint8)
        flat[pos:pos + b.size] = b
        return b.size

    def read_entries(self, start: int, stop: int) -> np.ndarray:
        """Row range [start, stop); decompresses covering baskets in
        parallel and read-ahead schedules the ``ahead`` baskets after.
        The covering rows are allocated once and each basket lands in its
        slice — no ``b"".join`` rematerialization."""
        idxs = self._covering(start, stop)
        if not idxs:
            return np.zeros((0,) + self.shape[1:], dtype=self.dtype)
        futs = self._acquire(idxs)
        self.prefetch(range(idxs[-1] + 1, idxs[-1] + 1 + self.ahead))
        total = sum(self._metas[i].orig_len for i in idxs)
        row_elems = int(np.prod(self.shape[1:], dtype=np.int64)) or 1
        rows = total // (self.dtype.itemsize * row_elems)
        arr = np.empty((rows,) + self.shape[1:], dtype=self.dtype)
        flat = arr.reshape(-1).view(np.uint8)
        pos = 0
        for f in futs:
            pos += self._scatter(flat, pos, f.result())
        self._trim()
        first_entry = self._metas[idxs[0]].entry_start
        return arr[start - first_entry: stop - first_entry].copy()

    def read_all(self) -> np.ndarray:
        """Whole branch: every basket scheduled at once, scattered in order
        into one destination allocation.

        Baskets already in the cache (or mid-decompression from an earlier
        prefetch) are consumed from their futures; the rest are submitted
        as decode-**into** tasks targeting the destination slice directly —
        those bypass the cache (their result is a byte count, not reusable
        bytes), which is the right trade for a bulk scan that would blow
        the LRU anyway.  Remote sources fetch the misses as one vectored
        wave and scatter the returned bytes."""
        out = np.empty(self.shape, dtype=self.dtype)
        flat = out.reshape(-1).view(np.uint8)
        offs, pos = byte_offsets(m.orig_len for m in self._metas)
        if pos != out.nbytes:   # malformed TOC; keep the copying fallback
            futs = self._acquire(range(len(self._metas)))
            chunks = [f.result() for f in futs]
            self._trim()
            buf = b"".join(bytes(c) for c in chunks)
            return np.frombuffer(buf, dtype=self.dtype).reshape(self.shape).copy()
        # classify under the lock; submit (and, for a serial engine,
        # *execute*) outside it — a multi-GB scan must not stall other
        # threads sharing this reader.  A basket cached by a concurrent
        # thread between the two phases just decodes twice (same bytes,
        # disjoint destinations), never corrupts.
        cached_tasks, missing = [], []
        with self._lock:
            for i in range(len(self._metas)):
                fut = self._cache.get(i)
                if fut is not None:
                    self.hits += 1
                    self._cache.move_to_end(i)
                    cached_tasks.append((i, fut))
                else:
                    self.misses += 1
                    missing.append(i)
        if cached_tasks:
            obs.counter("prefetch.requests", event="hit").inc(len(cached_tasks))
        if missing:
            obs.counter("prefetch.requests", event="miss").inc(len(missing))
        if self._source is not None:
            into_futs = list(zip(missing, self._submit(missing))) if missing else []
            for i, fut in cached_tasks + into_futs:
                self._scatter(flat, offs[i], fut.result())
            self._trim()
            return out
        into_futs = [self._engine.submit_unpack_into(
            self.path, self._offsets[i], self._meta_json[i],
            self._dictionary, self.verify,
            flat[offs[i]:offs[i] + self._metas[i].orig_len], self.generation)
            for i in missing]
        for i, fut in cached_tasks:
            self._scatter(flat, offs[i], fut.result())
        for fut in into_futs:
            fut.result()
        self._trim()
        return out

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            self._cache.clear()
        if self._owns_engine:
            self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

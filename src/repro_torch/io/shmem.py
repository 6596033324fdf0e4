"""Shared-memory slab pool — zero-pickle transport for process-pool codecs.

The pure-Python (GIL-holding) codecs run on a ``ProcessPoolExecutor``.  The
naive transport pickles the raw basket out and the payload back: each
direction is a serialize + pipe-write + pipe-read + deserialize of the full
buffer, chunked through a 64 KiB OS pipe.  This module replaces both
directions with a pool of pre-mapped ``multiprocessing.shared_memory``
slabs:

* the parent memcpys the raw chunk into a slab and submits only the slab
  *name* (a few bytes of pickle);
* the worker attaches the slab once (cached per process), reads the input
  in place, and — since the input is dead once the codec has run — writes
  the payload back over the same slab, returning just its length;
* the parent hands the payload slice to the file writer (``write()`` takes
  the memoryview directly) and recycles the slab.

Slabs are sized with headroom for incompressible payloads; a payload that
still doesn't fit falls back to the pickle path transparently, as does the
whole transport when ``/dev/shm`` is unavailable (``available()``).

Worker-side attachments deregister from ``resource_tracker`` — the parent
created the segments and owns their lifetime; without the deregistration a
worker exit would unlink slabs the parent is still using (bpo-39959).
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["SlabPool", "Slab", "available", "attach_view", "write_back"]

_HAVE: Optional[bool] = None
_HAVE_LOCK = threading.Lock()


def available() -> bool:
    """Probe (once) whether POSIX shared memory actually works here."""
    global _HAVE
    with _HAVE_LOCK:
        if _HAVE is None:
            try:
                from multiprocessing import shared_memory
                s = shared_memory.SharedMemory(create=True, size=64)
                s.buf[0] = 1
                s.close()
                s.unlink()
                _HAVE = True
            except Exception:
                _HAVE = False
        return _HAVE


# -- worker side -------------------------------------------------------------

_attached: dict = {}
_attach_lock = threading.Lock()


def _attach(name: str):
    """Attach (and cache) a slab created by the parent.

    Attaching must NOT register the segment with ``resource_tracker``: the
    parent created it and owns its lifetime, and pre-3.13
    ``SharedMemory(name=...)`` registers unconditionally (bpo-39959) — with
    the forkserver's *shared* tracker, a worker's registration/unregister
    pair would cancel the parent's and segments would be unlinked out from
    under live engines.  3.13+ has ``track=False`` for exactly this; on
    older versions registration is suppressed for the duration of the
    attach (serialized by ``_attach_lock``)."""
    from multiprocessing import shared_memory
    with _attach_lock:
        shm = _attached.get(name)
        if shm is not None:
            return shm
        try:
            shm = shared_memory.SharedMemory(name=name, track=False)
        except TypeError:   # pre-3.13: no track=; suppress registration
            from multiprocessing import resource_tracker
            orig = resource_tracker.register
            resource_tracker.register = lambda *a, **k: None
            try:
                shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = orig
        _attached[name] = shm
        return shm


def attach_view(name: str, nbytes: int) -> memoryview:
    """Worker-side zero-copy view of the first ``nbytes`` of a slab."""
    return memoryview(_attach(name).buf)[:nbytes]


def write_back(name: str, payload) -> Optional[int]:
    """Worker-side: overwrite the slab with ``payload`` if it fits.

    Returns the payload length, or None when the slab is too small (the
    caller then returns the payload itself through the pickle path)."""
    shm = _attach(name)
    n = len(payload)
    if n > shm.size:
        return None
    shm.buf[:n] = payload
    return n


# -- transport diagnostics (used by benchmarks/fig_zerocopy.py) --------------
# module-level so they pickle by reference under their real import path —
# the engine's process workers run with a bare __main__ by design.

def roundtrip_pickle(buf: bytes) -> bytes:
    """Pickle-transport probe: the buffer crosses the pipe both ways."""
    return buf


def roundtrip_slab(name: str, n: int) -> int:
    """Slab-transport probe: touch the slab in place (one worker-side
    memcpy, standing in for the codec's payload write); only the length
    crosses back."""
    view = attach_view(name, n)
    data = bytes(view)
    view.release()
    return len(data)


# -- parent side -------------------------------------------------------------

class Slab:
    __slots__ = ("shm", "size")

    def __init__(self, shm):
        self.shm = shm
        self.size = shm.size

    @property
    def name(self) -> str:
        return self.shm.name

    def fill(self, buf) -> int:
        """memcpy a buffer-protocol object into the slab; returns nbytes."""
        mv = memoryview(buf)
        if mv.ndim != 1 or mv.format != "B":
            mv = mv.cast("B")
        self.shm.buf[:mv.nbytes] = mv
        return mv.nbytes

    def view(self, nbytes: int) -> memoryview:
        return memoryview(self.shm.buf)[:nbytes]


def _margin(nbytes: int) -> int:
    # worst-case codec expansion (incompressible input + headers)
    return nbytes + nbytes // 64 + 4096


class SlabPool:
    """Bounded free-list of shared-memory slabs.

    The engine's ``max_inflight`` already bounds how many slabs are checked
    out at once, so ``acquire`` never blocks; it reuses the smallest free
    slab that fits or maps a fresh one.  ``close()`` unlinks everything."""

    def __init__(self, slab_bytes: int = 1 << 20,
                 max_outstanding: Optional[int] = None):
        self.slab_bytes = int(slab_bytes)
        self.max_outstanding = max_outstanding
        self._outstanding = 0
        self._free: list[Slab] = []
        self._all: list[Slab] = []
        self._lock = threading.Lock()
        self._closed = False

    def acquire(self, nbytes: int, _reserved: bool = False) -> Slab:
        need = _margin(nbytes)
        with self._lock:
            if self._closed:
                if _reserved:
                    self._outstanding -= 1
                raise RuntimeError("slab pool is closed")
            if not _reserved:
                self._outstanding += 1
            best = None
            for s in self._free:
                if s.size >= need and (best is None or s.size < best.size):
                    best = s
            if best is not None:
                self._free.remove(best)
                return best
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(
                create=True, size=max(need, _margin(self.slab_bytes)))
        except BaseException:
            with self._lock:
                self._outstanding -= 1
            raise
        slab = Slab(shm)
        with self._lock:
            if self._closed:  # closed while mapping: destroy, don't leak
                self._outstanding -= 1
                shm.close()
                shm.unlink()
                raise RuntimeError("slab pool is closed")
            self._all.append(slab)
        return slab

    def try_acquire(self, nbytes: int) -> Optional[Slab]:
        """``acquire``, unless ``max_outstanding`` slabs are already checked
        out — then None, and the caller uses its non-shm fallback.  Bounds
        slab memory when a reader schedules a whole branch at once.  The
        check-and-reserve is one locked step, so concurrent callers can't
        stampede past the cap."""
        with self._lock:
            if self.max_outstanding is not None \
                    and self._outstanding >= self.max_outstanding:
                return None
            self._outstanding += 1
        return self.acquire(nbytes, _reserved=True)

    def release(self, slab: Slab) -> None:
        with self._lock:
            self._outstanding = max(self._outstanding - 1, 0)
            if not self._closed:
                self._free.append(slab)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            slabs, self._all, self._free = self._all, [], []
        for s in slabs:
            # unlink first: it needs no exclusive mapping, so a consumer
            # still holding a yielded view can't keep the segment on disk
            try:
                s.shm.unlink()
            except Exception:
                pass
            try:
                s.shm.close()
            except Exception:
                pass

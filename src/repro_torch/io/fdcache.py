"""Cached positional reads — one fd per path, ``os.pread`` per basket.

The parallel unpack path used to ``open()``/``close()`` the container once
per basket, so a 64-worker decompress fan-out serialized on path resolution
and the dentry lock.  Here every (process, path) pair holds a single O_RDONLY
fd and baskets are read with ``os.pread`` — positional, thread-safe, no
seek state shared between workers.

Staleness: BasketFiles are written tmp-then-``os.replace``d, so a path can
start pointing at a *new* inode while a cached fd still references the old
one.  Each cache hit revalidates with one ``stat``: if the path's
(st_dev, st_ino) no longer matches the fd's, the fd is reopened.  That is
one cheap syscall versus the open+close pair (plus fd-table churn) it
replaces — and unlike an ``st_nlink`` probe it also holds on overlayfs,
where unlinked-but-open inodes keep reporting a link.

Reads *check out* their entry (a refcount taken under the lock), so LRU
eviction or ``invalidate()`` on another thread can only mark an in-use fd
dead — it is closed by the last reader checking it back in, never while a
``pread`` may still be using (or worse, a fresh ``open`` reusing) that fd
number.

The cache is per-process module state (process-pool workers each get their
own copy) and holds at most ``_MAX_FDS`` descriptors, evicted LRU.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

__all__ = ["pread", "patch", "generation", "invalidate", "clear",
           "StaleFileError", "set_fault_hook"]


class StaleFileError(OSError):
    """The path no longer points at the inode the caller captured.

    Raised by :func:`pread` when an ``expect`` generation is supplied and
    the path's current ``(st_dev, st_ino)`` differs — i.e. the container
    was atomically replaced after the caller read its TOC.  Readers catch
    this to re-open instead of mixing baskets from two file generations.
    """

_MAX_FDS = 64

_lock = threading.Lock()

# fault-injection hook (repro_torch.fault): when set, every pread's bytes pass
# through ``hook(path, offset, buf) -> bytes`` before the length check —
# returning short bytes simulates a torn read, mutated bytes simulate
# on-disk corruption, and a sleep inside simulates a slow device.  Test
# and chaos-soak machinery only; None (the default) costs one attribute
# load on the hot path.
_fault_hook = None


def set_fault_hook(hook):
    """Install ``hook(path, offset, buf) -> bytes`` on the pread path
    (None to remove).  Returns the previous hook so tests can restore."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, hook
    return prev


class _Entry:
    __slots__ = ("fd", "ident", "refs", "dead")

    def __init__(self, fd: int, ident: tuple):
        self.fd = fd
        self.ident = ident
        self.refs = 0
        self.dead = False


_entries: "OrderedDict[str, _Entry]" = OrderedDict()


def _close_quietly(fd: int) -> None:
    try:
        os.close(fd)
    except OSError:
        pass


def _retire(e: _Entry) -> None:
    """Mark dead; close now only if no reader holds it (the last reader
    closes it in ``_checkin`` otherwise).  Call with the lock held."""
    if not e.dead:
        e.dead = True
        if e.refs == 0:
            _close_quietly(e.fd)


def _checkout(path: str) -> _Entry:
    with _lock:
        e = _entries.get(path)
        if e is not None:
            try:
                st = os.stat(path)
                fresh = (st.st_dev, st.st_ino) == e.ident
            except OSError:
                fresh = False
            if fresh:
                _entries.move_to_end(path)
                e.refs += 1
                return e
            _entries.pop(path, None)
            _retire(e)
        fd = os.open(path, os.O_RDONLY)
        st = os.fstat(fd)
        e = _Entry(fd, (st.st_dev, st.st_ino))
        e.refs = 1
        _entries[path] = e
        while len(_entries) > _MAX_FDS:
            _, old = _entries.popitem(last=False)
            _retire(old)
        return e


def _checkin(e: _Entry) -> None:
    with _lock:
        e.refs -= 1
        if e.dead and e.refs == 0:
            _close_quietly(e.fd)


def pread(path: str, offset: int, n: int, expect: tuple | None = None) -> bytes:
    """Read ``n`` bytes at ``offset`` through the per-path cached fd.

    ``expect`` is a ``(st_dev, st_ino)`` generation captured when the
    caller read the file's TOC (see :func:`generation`); if the path now
    resolves to a different inode the read raises :class:`StaleFileError`
    instead of returning bytes from a file the TOC does not describe."""
    e = _checkout(path)
    try:
        if expect is not None and tuple(expect) != e.ident:
            raise StaleFileError(
                f"{path}: file was replaced (generation {e.ident} != "
                f"expected {tuple(expect)})")
        buf = os.pread(e.fd, n, offset)
    finally:
        _checkin(e)
    if _fault_hook is not None:
        buf = _fault_hook(path, offset, buf)
    if len(buf) != n:
        raise EOFError(f"{path}: short read at {offset}: {len(buf)} < {n}")
    return buf


def patch(path: str, offset: int, data: bytes,
          expect: tuple | None = None) -> None:
    """Overwrite ``len(data)`` bytes at ``offset`` **in place** — the
    repair primitive (repro_torch.repair heals a rotted basket by writing the
    reconstructed payload back over the damage).

    In-place on purpose: a tmp-then-replace rewrite would change the
    inode and stale every open reader/cache generation, while an in-place
    patch restores the *original* bytes of the same generation — readers
    that captured the inode keep being right.  The write goes through a
    short-lived O_RDWR fd (the cached read fd stays O_RDONLY) and is
    fsynced before returning.  ``expect`` gives the same staleness guard
    as :func:`pread`."""
    fd = os.open(path, os.O_RDWR)
    try:
        st = os.fstat(fd)
        if expect is not None and tuple(expect) != (st.st_dev, st.st_ino):
            raise StaleFileError(
                f"{path}: file was replaced (generation "
                f"{(st.st_dev, st.st_ino)} != expected {tuple(expect)})")
        view = memoryview(data)
        pos = offset
        while view:
            n = os.pwrite(fd, view, pos)
            pos += n
            view = view[n:]
        os.fsync(fd)
    finally:
        _close_quietly(fd)


def generation(path: str) -> tuple[int, int]:
    """The path's current ``(st_dev, st_ino)`` identity — the generation
    key used by every basket cache (prefetch LRU, remote tiered cache) so
    a replaced file can never serve stale cached baskets.  Goes through
    the fd cache, so the identity matches what :func:`pread` will read."""
    e = _checkout(path)
    try:
        return e.ident
    finally:
        _checkin(e)


def invalidate(path: str) -> None:
    with _lock:
        e = _entries.pop(path, None)
        if e is not None:
            _retire(e)


def clear() -> None:
    with _lock:
        entries = list(_entries.values())
        _entries.clear()
        for e in entries:
            _retire(e)

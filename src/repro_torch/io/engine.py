"""Pipelined basket-granular compression engine.

ROOT's answer to the single-core compression wall (the paper's closing
argument, mechanised in *Increasing Parallelism in the ROOT I/O Subsystem*,
arXiv:1804.03326) is task parallelism at basket granularity: when a TTree
flushes, each basket becomes an independent compression task and the writer
commits finished payloads in order.  This module is that mechanism:

* ``CompressionEngine`` owns a bounded worker pool.  ``pack_stream`` takes
  the (entry_start, entry_count, buffer) chunk stream produced by
  :func:`repro_torch.core.basket.split_array`, compresses up to ``max_inflight``
  baskets concurrently, and yields ``(start, count, payload, meta)``
  strictly in submission order — so the caller writes at monotonically
  increasing offsets exactly like the serial path, and the output file is
  **byte-identical** to serial output (``pack_basket`` is deterministic and
  commit order equals submission order).

* Backpressure: the submitting side blocks once ``max_inflight`` baskets
  are in flight, bounding memory at ~``max_inflight * basket_bytes``
  regardless of branch size — a slow disk never lets the compressors run
  unboundedly ahead.

* GIL routing: C-backed codecs (zlib, lzma, libzstd) release the GIL while
  compressing, so a thread pool scales them across cores.  The from-scratch
  pure-Python codecs (our lz4 block format and the repro-deflate family)
  hold the GIL; for those the engine transparently uses a process pool.

* Zero-copy transport: process-pool tasks move their buffers through a
  ``multiprocessing.shared_memory`` slab pool (``repro_torch.io.shmem``) instead
  of pickled-bytes pipe round-trips — the parent memcpys the raw chunk
  into a pre-mapped slab, the worker compresses in place and writes the
  payload back over the same slab, and only slab names and lengths cross
  the pipe.  Falls back to the pickle transport when shared memory is
  unavailable (``shm=False`` forces the fallback).  Output bytes are
  identical either way.

Payload lifetime: ``pack_stream`` may yield payloads that are memoryviews
(into a slab, or into the caller's own source array on the serial identity
path).  They are valid until the generator is advanced or closed; consumers
that retain payloads must ``bytes()`` them (``BasketWriter`` writes them to
disk immediately; ``BasketBuffer`` copies).

The engine is shared: one instance can serve many branches, many writers,
and the prefetching reader (``repro_torch.io.prefetch``) simultaneously.
"""

from __future__ import annotations

import contextlib
import logging
import multiprocessing as mp
import os
import sys
import threading
import time
from collections import deque
from concurrent.futures import (CancelledError, Executor, Future,
                                ProcessPoolExecutor, ThreadPoolExecutor)
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import basket as _basket
from repro_torch.core import codec as _codec

from . import fdcache as _fdcache
from . import shmem as _shmem

__all__ = ["CompressionEngine", "cpu_count"]

_LOG = logging.getLogger("repro_torch.io")


def cpu_count() -> int:
    return os.cpu_count() or 1


# ---------------------------------------------------------------------------
# module-level task bodies (picklable, so the process backend can run them)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _task_span(name: str, tp, **args):
    """Span for an engine task body, recorded only when a caller's
    traceparent rode in with the task — per-basket spans on untraced bulk
    workloads would flood the ring for nothing.  With ``tp`` set, the
    span joins the caller's trace even across the process-pool boundary
    (the worker's ring folds back on :meth:`CompressionEngine.collect_obs`)."""
    if not tp:
        yield
        return
    with obs.context.activated(tp):
        with obs.trace.span(name, cat="engine", **args):
            yield


def _obs_pack(raw, cfg, start: int, count: int, tp=None, pre=None):
    """pack_basket with stage telemetry.  Runs in whichever worker executes
    the task: thread workers hit the parent registry directly; process
    workers hit their own, folded back by :meth:`CompressionEngine.collect_obs`.

    ``pre=(orig_len, checksum)`` marks ``raw`` as already preconditioned
    (on the GPU), described by the raw bytes' length and adler32."""
    t0 = time.perf_counter()
    with _task_span("engine.pack", tp, algo=cfg.algo), \
            obs.profile.mem_phase("engine.pack"):
        if pre is None:
            payload, meta = _basket.pack_basket(raw, cfg, entry_start=start,
                                                entry_count=count)
        else:
            payload, meta = _basket.pack_preconditioned(
                raw, cfg, *pre, entry_start=start, entry_count=count)
    obs.histogram("engine.pack_s", algo=cfg.algo).observe(
        time.perf_counter() - t0)
    obs.counter("engine.pack.bytes_in", algo=cfg.algo).inc(meta.orig_len)
    obs.counter("engine.pack.bytes_out", algo=cfg.algo).inc(meta.comp_len)
    return payload, meta


def _pack_task(raw, cfg_fields: tuple, start: int, count: int, tp=None,
               pre=None):
    cfg = _codec.CompressionConfig(*cfg_fields)
    payload, meta = _obs_pack(raw, cfg, start, count, tp, pre)
    return start, count, payload, meta


def _pack_task_shm(slab_name: str, nbytes: int, cfg_fields: tuple,
                   start: int, count: int, tp=None, pre=None):
    """Worker body for the slab transport: input read in place from the
    slab, payload written back over it (the input is dead by then).  The
    return value carries only the payload *length* — or the payload bytes
    themselves if they outgrew the slab (incompressible + header margin
    exceeded), which the parent handles transparently."""
    raw = _shmem.attach_view(slab_name, nbytes)
    cfg = _codec.CompressionConfig(*cfg_fields)
    payload, meta = _obs_pack(raw, cfg, start, count, tp, pre)
    if payload is raw:          # identity config: content already in place
        return start, count, nbytes, meta
    n = _shmem.write_back(slab_name, payload)
    if n is None:
        return start, count, bytes(payload), meta
    return start, count, n, meta


def _measure_trial(sample, cfg: "_codec.CompressionConfig", reps: int):
    """Timed compress + decompress-into of one payload (best-of-reps).

    Each measurement lands in the obs registry — per-algo rate histograms
    plus a trial counter — so calibration evidence is inspectable after
    the fact (obstat / STATS) instead of collapsing into one returned
    number.  The return value is still the best-of-reps cost-model point
    the tuner selects on."""
    t_c = float("inf")
    payload = meta = None
    for _ in range(reps):
        t0 = time.perf_counter()
        payload, meta = _basket.pack_basket(sample, cfg)
        t_c = min(t_c, time.perf_counter() - t0)
    out = np.empty(meta.orig_len, np.uint8)
    t_d = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _basket.unpack_basket_into(payload, meta, out, cfg.dictionary,
                                   verify=False)
        t_d = min(t_d, time.perf_counter() - t0)
    obs.counter("tune.trials", algo=cfg.algo).inc()
    obs.histogram("tune.trial_s", algo=cfg.algo).observe(t_c + t_d)
    mb = meta.orig_len / 1e6
    if t_c > 0:
        obs.histogram("tune.trial.comp_mbps", algo=cfg.algo).observe(mb / t_c)
    if t_d > 0:
        obs.histogram("tune.trial.decomp_mbps", algo=cfg.algo).observe(mb / t_d)
    return meta.orig_len, meta.comp_len, t_c, t_d


def _trial_task(sample, cfg_fields: tuple, reps: int = 1,
                budget_s: Optional[float] = None):
    """One autotuner trial: compress the sampled payload, then decompress
    it back through the zero-copy into-path, timing both (best-of-reps).
    Returns ``(orig_len, comp_len, comp_s, decomp_s)`` — the raw cost-model
    point ``repro_torch.tune`` wraps into a TrialResult.

    ``budget_s`` bounds the per-candidate cost: an eighth of the sample is
    measured first, and the full sample runs only if the extrapolated cost
    fits the budget — so a slow candidate (the pure-Python cores can run
    at single-digit MB/s) is ranked from its probe instead of stalling the
    trial matrix.  The probe keeps the sample's stratification: it takes
    the leading eighth of each of 8 equal segments (= a slice of every
    sampler window), not a head-only prefix — head-only probing is the
    mistuning mode the stratified sampler exists to avoid.
    """
    cfg = _codec.CompressionConfig(*cfg_fields)
    reps = max(int(reps), 1)
    n = _buf_len(sample)
    if budget_s is not None and n >= 4096:
        a = np.frombuffer(sample, np.uint8) \
            if not isinstance(sample, np.ndarray) else sample.reshape(-1)
        seg = n // 8
        sub = max((seg // 8) & ~7, 8)    # element-aligned for every precond
        probe = np.concatenate([a[(i * seg) & ~7:((i * seg) & ~7) + sub]
                                for i in range(8)])
        cut = probe.size
        res = _measure_trial(probe, cfg, 1)
        est = (res[2] + res[3]) * (n / max(cut, 1)) * reps
        if est > budget_s:
            return res
    return _measure_trial(sample, cfg, reps)


def _unpack_task(path: str, offset: int, meta_json: dict,
                 dictionary: Optional[bytes], verify: bool,
                 ident: Optional[tuple] = None, tp=None) -> bytes:
    meta = _basket.BasketMeta.from_json(meta_json)
    with _task_span("engine.unpack", tp, algo=meta.algo), \
            obs.profile.mem_phase("engine.unpack"):
        payload = _fdcache.pread(path, offset, meta.comp_len, expect=ident)
        t0 = time.perf_counter()
        raw = _basket.unpack_basket(payload, meta, dictionary, verify=verify)
    obs.histogram("engine.unpack_s", algo=meta.algo).observe(
        time.perf_counter() - t0)
    obs.counter("engine.unpack.bytes_out", algo=meta.algo).inc(meta.orig_len)
    return raw


def _unpack_task_into(path: str, offset: int, meta_json: dict,
                      dictionary: Optional[bytes], verify: bool, out,
                      ident: Optional[tuple] = None, tp=None) -> int:
    """Read + decompress one basket directly into ``out`` (same-process
    destination slice — the thread-pool / serial scatter path)."""
    meta = _basket.BasketMeta.from_json(meta_json)
    with _task_span("engine.unpack", tp, algo=meta.algo):
        payload = _fdcache.pread(path, offset, meta.comp_len, expect=ident)
        t0 = time.perf_counter()
        n = _basket.unpack_basket_into(payload, meta, out, dictionary,
                                       verify=verify)
    obs.histogram("engine.unpack_s", algo=meta.algo).observe(
        time.perf_counter() - t0)
    obs.counter("engine.unpack.bytes_out", algo=meta.algo).inc(meta.orig_len)
    return n


def _unpack_task_shm(path: str, offset: int, meta_json: dict,
                     dictionary: Optional[bytes], verify: bool,
                     slab_name: str, ident: Optional[tuple] = None, tp=None):
    """Worker body: decode into the slab; only the length crosses back."""
    raw = _unpack_task(path, offset, meta_json, dictionary, verify, ident, tp)
    n = _shmem.write_back(slab_name, raw)
    return raw if n is None else n


def _cfg_fields(cfg: _codec.CompressionConfig) -> tuple:
    return (cfg.algo, cfg.level, cfg.precond, cfg.dictionary)


_buf_len = _basket._nbytes      # byte length of any buffer-protocol object


def _warm_task(delay: float = 0.0):
    if delay:
        time.sleep(delay)
    return None


def _obs_snapshot_task(delay: float = 0.0):
    """Worker body for telemetry folding: each process worker returns (and
    zeroes) its own registry's delta snapshot plus its drained trace ring
    and profile folds, so worker spans/samples are not lost at the pool
    boundary.  The sleep is the warmup trick — N sleeping tasks for N
    workers means one eager worker can't answer them all, so every worker
    gets drained."""
    if delay:
        time.sleep(delay)
    return {"metrics": obs.snapshot(reset=True),
            "trace": obs.trace.drain(),
            "profile": obs.profile.drain()}


def _prof_ctl_task(action: str, hz: float, mem, delay: float = 0.0):
    """Worker body for profiler control: start/stop the sampling profiler
    *inside* a process-pool worker, so a pool workload's flamegraph
    includes worker stacks (folded back by ``_obs_snapshot_task``).  Same
    sleeping-warmup trick — every worker must be reached."""
    if delay:
        time.sleep(delay)
    if action == "start":
        return obs.profile.start(hz=hz, mem=mem)
    obs.profile.stop()
    return True


def _completed_future(fn, *args) -> Future:
    """Run ``fn`` now, wrapped in a Future (mirrors executor semantics)."""
    f: Future = Future()
    try:
        f.set_result(fn(*args))
    except Exception as e:
        f.set_exception(e)
    return f


_SENTINEL = object()

# __main__.__spec__/__file__ are process-global: the hide/spawn/restore
# window below must be exclusive across ALL engines, not just one
_SPAWN_LOCK = threading.Lock()


def _restore_attr(obj, name, saved) -> None:
    if saved is _SENTINEL:
        try:
            delattr(obj, name)
        except AttributeError:
            pass
    else:
        setattr(obj, name, saved)


class CompressionEngine:
    """Bounded worker pool with in-order streaming commit.

    ``workers=0`` degrades to fully serial execution (no pool, no threads),
    which is what makes ``BasketWriter(workers=0)`` bit-for-bit the old
    serial writer with zero overhead.

    ``shm`` controls the process-pool transport: ``"auto"`` (default) uses
    the shared-memory slab pool when the platform supports it, ``False``
    forces the pickled-bytes fallback, ``True`` insists (still falling back
    with a warning if shared memory is unavailable).
    """

    def __init__(self, workers: int = 0, max_inflight: Optional[int] = None,
                 unpack_processes: bool = False,
                 inline_bytes: int = 16384,
                 shm="auto"):
        self.workers = max(int(workers), 0)
        self.max_inflight = max_inflight or max(2 * self.workers, 1)
        # Decompression defaults to the thread pool even for pure-Python
        # codecs: readers are created ad hoc (one per file/branch), and a
        # process pool's worker-import cost would dwarf the decode work.
        # Long steady-state scans can opt in to process decompression.
        self.unpack_processes = unpack_processes
        # Baskets smaller than this compress inline in the caller instead
        # of being shipped to a pool.  Re-tuned for the vectorized codec
        # cores: single-core throughput rose ~3-8x, so the payload size
        # where process-pool pickling/IPC pays for itself moved up — a
        # 16 KiB basket now compresses in well under the round-trip cost.
        self.inline_bytes = max(int(inline_bytes), 0)
        self.shm = shm
        self._thread_pool: Optional[ThreadPoolExecutor] = None
        self._proc_pool: Optional[ProcessPoolExecutor] = None
        self._slab_pool: Optional[_shmem.SlabPool] = None
        self._lock = threading.Lock()
        self._closed = False

    # -- pools -----------------------------------------------------------

    def _pool_for(self, algo: str) -> Optional[Executor]:
        """Thread pool for GIL-releasing codecs, process pool otherwise."""
        if self.workers == 0:
            return None
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if _codec.is_pure_python(algo):
                if self._proc_pool is None:
                    self._proc_pool = self._spawn_process_pool()
                return self._proc_pool
            if self._thread_pool is None:
                self._thread_pool = ThreadPoolExecutor(
                    self.workers, thread_name_prefix="repro-io")
            return self._thread_pool

    def _slabs(self) -> Optional[_shmem.SlabPool]:
        """The slab pool serving the process transport (None = pickle)."""
        if self.shm is False:
            return None
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._slab_pool is None:
                if not _shmem.available():
                    if self.shm is True:
                        _LOG.warning("shared memory unavailable; "
                                     "falling back to pickle transport")
                    self.shm = False
                    return None
                self._slab_pool = _shmem.SlabPool(
                    max_outstanding=4 * self.workers + 8)
            return self._slab_pool

    def _spawn_process_pool(self) -> ProcessPoolExecutor:
        """Pool for GIL-holding codecs, started so it can never run user
        code or deadlock:

        * *forkserver* context — workers fork from a clean server process,
          never from this (possibly jax-threaded) one, so no lock held by a
          sibling thread can deadlock a child (plain ``fork`` can);
        * every worker is spawned HERE with ``__main__``'s ``__spec__``/
          ``__file__`` temporarily hidden.  forkserver (like spawn)
          otherwise re-imports ``__main__`` per worker, which re-executes
          unguarded user scripts (hanging the pool on the re-entrant
          ``ProcessPoolExecutor``) and crashes outright for stdin scripts
          (``python - <<EOF``: ``__file__`` doesn't exist on disk).  Our
          tasks are module-level functions in this module — workers never
          need ``__main__`` at all, so a bare one is correct.
        """
        try:
            ctx = mp.get_context("forkserver")
        except ValueError:  # pragma: no cover - non-POSIX
            ctx = None
        with _SPAWN_LOCK:
            main = sys.modules.get("__main__")
            saved_spec = getattr(main, "__spec__", _SENTINEL) if main else _SENTINEL
            saved_file = getattr(main, "__file__", _SENTINEL) if main else _SENTINEL
            try:
                if main is not None:
                    main.__spec__ = None
                    main.__file__ = None
                pool = ProcessPoolExecutor(self.workers, mp_context=ctx)
                # submit() is what forks workers; preparation data (incl.
                # the hidden __main__ info) is captured synchronously per
                # spawn, so all workers must spawn inside this window
                futs = [pool.submit(_warm_task, 0.05)
                        for _ in range(self.workers)]
            finally:
                if main is not None:
                    _restore_attr(main, "__spec__", saved_spec)
                    _restore_attr(main, "__file__", saved_file)
        for f in futs:
            f.result()
        return pool

    def warmup(self, algo: str = "zlib") -> None:
        """Pre-start the pool serving ``algo`` (process pools fork lazily;
        benchmarks warm up so curves show steady-state throughput).  The
        warm tasks sleep briefly so one eager worker can't drain them all —
        every worker must spawn (and pay its module import) now."""
        pool = self._pool_for(algo)
        if pool is not None:
            delay = 0.25 if isinstance(pool, ProcessPoolExecutor) else 0.0
            for f in [pool.submit(_warm_task, delay)
                      for _ in range(self.workers)]:
                f.result()

    def collect_obs(self, delay: float = 0.05) -> None:
        """Fold process-pool workers' metric deltas *and trace rings* into
        this process's registry/ring.  Thread workers already share them;
        only the forkserver children have private copies.  Safe to call
        repeatedly — metric snapshots are reset-deltas and rings drain, so
        nothing double-counts and no span is folded twice."""
        if not obs.enabled():
            return
        with self._lock:
            pool = self._proc_pool
        if pool is None:
            return
        try:
            futs = [pool.submit(_obs_snapshot_task, delay)
                    for _ in range(self.workers)]
            for f in futs:
                got = f.result()
                if isinstance(got, dict) and "metrics" in got:
                    obs.merge(got["metrics"])
                    obs.trace.ingest(got.get("trace") or [])
                    obs.profile.ingest(got.get("profile"))
                else:       # a worker running the pre-v2 task body
                    obs.merge(got)
        except Exception:   # broken pool at teardown: telemetry is advisory
            pass

    def profile_workers(self, action: str = "start",
                        hz: float = 0.0, mem=False,
                        delay: float = 0.05) -> None:
        """Start or stop the sampling profiler inside every process-pool
        worker (thread workers already share the parent's profiler).  The
        workers' samples fold back on :meth:`collect_obs` / ``close()``.

        ``"start"`` spawns the process pool if it doesn't exist yet —
        the pool is otherwise lazy (first pure-python pack), and the
        natural call order is "arm the profiler, then run the workload",
        which would silently profile nothing against a not-yet-spawned
        pool.  ``"stop"`` against no pool is a no-op, as is everything
        when obs is disabled or ``workers == 0``."""
        if not obs.enabled() or self.workers == 0:
            return
        with self._lock:
            if self._closed:
                return
            if self._proc_pool is None:
                if action != "start":
                    return
                self._proc_pool = self._spawn_process_pool()
            pool = self._proc_pool
        hz = hz or obs.profile.DEFAULT_HZ
        try:
            futs = [pool.submit(_prof_ctl_task, action, hz, mem, delay)
                    for _ in range(self.workers)]
            for f in futs:
                f.result()
        except Exception:   # broken pool at teardown: profiling is advisory
            pass

    def close(self) -> None:
        self.collect_obs()
        with self._lock:
            self._closed = True
            pools = [p for p in (self._thread_pool, self._proc_pool) if p]
            self._thread_pool = self._proc_pool = None
            slab_pool, self._slab_pool = self._slab_pool, None
        for p in pools:
            p.shutdown(wait=True)
        if slab_pool is not None:   # after shutdown: no worker still maps them
            slab_pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- ordered map (the pipeline primitive) ----------------------------

    @staticmethod
    def _drain(fut: Future) -> None:
        """Cancel a pending future; if it is already running, wait it out
        and surface (log) its exception — a failing worker must not die
        silently just because the consumer closed the stream early."""
        if fut.cancel():
            return
        try:
            exc = fut.exception()
        except CancelledError:  # pragma: no cover - raced cancellation
            return
        if exc is not None:
            _LOG.warning("repro_torch.io worker failed during pipeline teardown: %r",
                         exc)

    def _map_ordered(self, pool: Optional[Executor], submit_one,
                     items: Iterable) -> Iterator:
        """Yield results in submission order, ≤ max_inflight in flight.

        The deque head is the oldest future; blocking on it while the tail
        keeps compressing is what pipelines compression with the caller's
        sequential disk writes."""
        if pool is None:
            for it in items:
                yield submit_one(None, it)
            return
        pending: deque[Future] = deque()
        depth = obs.gauge("engine.inflight")
        it = iter(items)
        exhausted = False
        try:
            while pending or not exhausted:
                while not exhausted and len(pending) < self.max_inflight:
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(submit_one(pool, item))
                depth.set(len(pending))
                if pending:
                    yield pending.popleft().result()
        finally:
            depth.set(0)
            for f in pending:
                self._drain(f)

    # -- generic compute (shared-service hook) ---------------------------

    def submit(self, fn, *args) -> Future:
        """Run ``fn(*args)`` on the engine's thread pool (inline when
        ``workers=0``) — the shared-compute hook for services built on one
        engine, e.g. the remote basket server's wire transcoding, where
        the C archive codecs release the GIL while decoding."""
        pool = self._pool_for("none")      # the thread pool
        if pool is None:
            return _completed_future(fn, *args)
        return pool.submit(fn, *args)

    # -- compression side ------------------------------------------------

    def pack_stream(self, chunks: Iterable[tuple[int, int, bytes]],
                    cfg: _codec.CompressionConfig) -> Iterator[tuple]:
        """(start, count, buffer) stream -> (start, count, payload, meta)
        stream, in order, compressed ``workers``-wide.  Input buffers may
        be any buffer-protocol object; yielded payloads are bytes-like and
        valid until the next iteration (copy if retained).  A chunk
        ``(start, count, buffer, orig_len, checksum)`` carries a buffer
        whose ``cfg.precond`` already ran (on the GPU): it is only
        compressed, with metadata for the raw bytes it describes."""
        pool = self._pool_for(cfg.algo if cfg.enabled else "none")
        fields = _cfg_fields(cfg)
        tp = obs.context.current_traceparent()
        if isinstance(pool, ProcessPoolExecutor):
            slabs = self._slabs()
            if slabs is not None:
                return self._pack_stream_shm(pool, slabs, chunks, fields, tp)
        inline = self.inline_bytes

        def submit_one(p, chunk):
            start, count, raw, *pre = chunk
            pre = tuple(pre) or None
            if p is None:
                return _pack_task(raw, fields, start, count, tp, pre)
            if _buf_len(raw) < inline:
                # small basket: the pool round-trip (pickle + IPC + wakeup)
                # costs more than compressing right here
                return _completed_future(_pack_task, raw, fields, start,
                                         count, tp, pre)
            if isinstance(p, ProcessPoolExecutor) and \
                    not isinstance(raw, (bytes, bytearray)):
                raw = bytes(raw)    # pickle transport needs a real object
            return p.submit(_pack_task, raw, fields, start, count, tp, pre)

        return self._map_ordered(pool, submit_one, chunks)

    def _pack_stream_shm(self, pool: ProcessPoolExecutor,
                         slabs: _shmem.SlabPool, chunks: Iterable,
                         fields: tuple, tp=None) -> Iterator[tuple]:
        """pack_stream over the slab transport: same ordered-commit loop,
        but each in-flight basket owns a slab carrying raw input out and
        the payload back.  Yielded payloads may view the slab — the slab is
        recycled when the generator is advanced."""
        pending: deque = deque()    # (future, slab | None)
        depth = obs.gauge("engine.inflight")
        it = iter(chunks)
        exhausted = False
        inline = self.inline_bytes
        try:
            while pending or not exhausted:
                while not exhausted and len(pending) < self.max_inflight:
                    try:
                        start, count, raw, *pre = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pre = tuple(pre) or None
                    n = _buf_len(raw)
                    if n < inline:
                        pending.append((_completed_future(
                            _pack_task, raw, fields, start, count, tp, pre),
                            None))
                        continue
                    slab = slabs.acquire(n)
                    try:
                        slab.fill(raw)
                        fut = pool.submit(_pack_task_shm, slab.name, n,
                                          fields, start, count, tp, pre)
                    except BaseException:
                        slabs.release(slab)
                        raise
                    pending.append((fut, slab))
                depth.set(len(pending))
                if pending:
                    fut, slab = pending.popleft()
                    try:
                        start, count, payload, meta = fut.result()
                    except BaseException:
                        if slab is not None:
                            slabs.release(slab)
                        raise
                    if slab is None:
                        yield start, count, payload, meta
                        continue
                    try:
                        if isinstance(payload, int):
                            view = slab.view(payload)
                            try:
                                yield start, count, view, meta
                            finally:
                                view.release()
                        else:   # payload outgrew the slab: came back pickled
                            yield start, count, payload, meta
                    finally:
                        slabs.release(slab)
        finally:
            depth.set(0)
            for fut, slab in pending:
                self._drain(fut)
                if slab is not None:
                    slabs.release(slab)

    # -- decompression side (used by the prefetching reader) -------------

    def submit_unpack(self, path: str, offset: int, meta_json: dict,
                      dictionary: Optional[bytes], verify: bool,
                      ident: Optional[tuple] = None) -> Future:
        """Schedule one basket's read+decompress; returns a Future[bytes].
        ``ident`` is the container's captured (st_dev, st_ino) generation —
        the read fails with ``StaleFileError`` if the path was replaced."""
        algo = meta_json.get("algo", "none") if self.unpack_processes else "none"
        pool = self._pool_for(algo)
        tp = obs.context.current_traceparent()
        if pool is None:
            return _completed_future(_unpack_task, path, offset, meta_json,
                                     dictionary, verify, ident, tp)
        if pool is self._proc_pool:
            slabs = self._slabs()
            if slabs is not None:
                return self._submit_unpack_shm(pool, slabs, path, offset,
                                               meta_json, dictionary, verify,
                                               ident, tp)
        return pool.submit(_unpack_task, path, offset, meta_json,
                           dictionary, verify, ident, tp)

    @staticmethod
    def _submit_unpack_shm(pool, slabs, path, offset, meta_json,
                           dictionary, verify, ident=None, tp=None) -> Future:
        """Process unpack over the slab transport: the worker decodes into
        a slab; the parent's completion callback lifts the bytes out (one
        memcpy instead of a pickled pipe round-trip) and recycles it.
        Falls back to the pickle transport when the pool's outstanding-slab
        cap is hit (a reader scheduling a whole branch at once must not map
        the whole branch in slabs)."""
        slab = slabs.try_acquire(int(meta_json["orig_len"]))
        if slab is None:
            return pool.submit(_unpack_task, path, offset, meta_json,
                               dictionary, verify, ident, tp)
        try:
            inner = pool.submit(_unpack_task_shm, path, offset, meta_json,
                                dictionary, verify, slab.name, ident, tp)
        except BaseException:
            slabs.release(slab)
            raise
        outer: Future = Future()

        def _done(f: Future) -> None:
            try:
                res = f.result()
                data = bytes(slab.view(res)) if isinstance(res, int) else res
            except BaseException as e:
                slabs.release(slab)
                outer.set_exception(e)
                return
            slabs.release(slab)
            outer.set_result(data)

        inner.add_done_callback(_done)
        return outer

    # -- autotuner trials (used by repro_torch.tune) ---------------------------

    def submit_trial(self, sample, cfg_fields: tuple, reps: int = 1,
                     budget_s: Optional[float] = None) -> Future:
        """Schedule one tuner trial (compress + decompress the sampled
        payload under ``cfg_fields``, timed); returns a Future of
        ``(orig_len, comp_len, comp_s, decomp_s)``.  Routed like any
        compression task: thread pool for GIL-releasing codecs, process
        pool for the pure-Python cores — so a trial matrix measures
        ``workers``-wide.  Timings are taken inside the worker; under a
        loaded pool concurrent trials contend for cores, which perturbs
        absolute MB/s but preserves the ranking the tuner selects on."""
        pool = self._pool_for(cfg_fields[0])
        if pool is None:
            return _completed_future(_trial_task, sample, cfg_fields, reps,
                                     budget_s)
        if isinstance(pool, ProcessPoolExecutor) and \
                not isinstance(sample, (bytes, bytearray)):
            sample = bytes(sample)      # pickle transport needs a real object
        return pool.submit(_trial_task, sample, cfg_fields, reps, budget_s)

    def submit_unpack_into(self, path: str, offset: int, meta_json: dict,
                           dictionary: Optional[bytes], verify: bool,
                           out, ident: Optional[tuple] = None) -> Future:
        """Schedule one basket's read+decompress **into** ``out`` (a
        writable 1-D uint8 view of the destination array slice); returns a
        Future[int] of bytes written.  Thread/serial workers decode in
        place; process workers decode remotely and the completion callback
        memcpys into ``out``."""
        algo = meta_json.get("algo", "none") if self.unpack_processes else "none"
        pool = self._pool_for(algo)
        tp = obs.context.current_traceparent()
        if pool is None:
            return _completed_future(_unpack_task_into, path, offset,
                                     meta_json, dictionary, verify, out,
                                     ident, tp)
        if pool is self._proc_pool:
            slabs = self._slabs()
            slab = slabs.try_acquire(int(meta_json["orig_len"])) \
                if slabs is not None else None
            try:
                if slab is not None:
                    # decode lands in the slab; scatter it straight into
                    # the destination slice — one memcpy, no intermediate
                    inner = pool.submit(_unpack_task_shm, path, offset,
                                        meta_json, dictionary, verify,
                                        slab.name, ident, tp)
                else:
                    inner = pool.submit(_unpack_task, path, offset,
                                        meta_json, dictionary, verify,
                                        ident, tp)
            except BaseException:
                if slab is not None:
                    slabs.release(slab)
                raise
            outer: Future = Future()

            def _done(f: Future) -> None:
                try:
                    res = f.result()
                    if isinstance(res, int):
                        view = slab.view(res)
                        out[:res] = np.frombuffer(view, dtype=np.uint8)
                        view.release()
                        n = res
                    else:
                        src = np.frombuffer(res, dtype=np.uint8)
                        out[:src.size] = src
                        n = src.size
                except BaseException as e:
                    if slab is not None:
                        slabs.release(slab)
                    outer.set_exception(e)
                    return
                if slab is not None:
                    slabs.release(slab)
                outer.set_result(n)

            inner.add_done_callback(_done)
            return outer
        return pool.submit(_unpack_task_into, path, offset, meta_json,
                           dictionary, verify, out, ident, tp)

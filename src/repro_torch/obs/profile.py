"""Continuous sampling profiler: span-attributed flamegraphs plus
per-phase memory watermarks (DESIGN.md §17).

The metrics registry (§13) says *which verb* is slow and the trace ring
(§16) says *which request*, but neither says which *code* burned the
time inside a span.  This module closes that gap with a wall-clock
sampler: a daemon thread wakes at ``hz`` and walks every thread's
current Python stack via ``sys._current_frames()``, folding each
observation into a collapsed-stack dict (``"root;child;leaf" ->
count``) — the flamegraph input format.  Sampling is proportional: a
function's share of samples estimates its share of wall time, and the
cost is one stack walk per thread per tick regardless of how hot the
code is — no per-call instrumentation, safe to leave on in production.

**Span attribution.**  When the profiler is active, ``trace.span``
registers the span name (and trace id, if the span carries one) in a
per-thread registry here, and every sample taken on that thread is
prefixed with a ``span:<name>`` frame.  A fold therefore reads
"``span:rbsp.serve`` spent 41 samples under ``transcode_many`` →
``pack_basket``" — the §16 causal tree extended down to function
granularity.  The registry is a plain dict of per-thread lists mutated
only by the owning thread (GIL-atomic append/pop); the sampler reads
``stack[-1]`` racily and tolerates torn reads — attribution may be off
by one sample at a span boundary, never wrong by more.

**Memory watermarks.**  :func:`mem_phase` wraps a named phase (engine
pack/unpack, server READV, tuner trial matrix, checkpoint save/load,
serve prefill/decode) and records its peak memory: the tracemalloc peak
when tracing is on (exact Python-heap peak, ~2x allocation overhead —
opt in with ``start(mem="tracemalloc")``), else the RSS delta from
``/proc/self/statm`` (free, catches native/numpy allocations tracemalloc
can't see).  Watermarks land both in module state (the flight recorder's
``watermarks`` table) and in the ``mem.phase_peak_bytes{phase=}``
histogram.

**Worker folding.**  Process-pool workers sample into their own module
state; :meth:`repro_torch.io.engine.CompressionEngine.collect_obs` drains it
(:func:`drain` in the child, :func:`ingest` in the parent) exactly like
§16 trace rings, so a flamegraph of a pool workload includes the
workers' stacks.  Remote capture rides the RBSP ``PROF`` verb
(``remote.client.request_prof``).

Everything honors the shared ``REPRO_OBS`` gate: with obs disabled the
sampler skips its tick, ``mem_phase`` returns a shared no-op, and
``trace.span`` never calls in (it checks :data:`_ACTIVE` first).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

from repro_torch.obs import metrics as _metrics

__all__ = [
    "start", "stop", "active", "status", "snapshot", "drain", "ingest",
    "reset", "collapsed", "speedscope", "self_counts", "mem_phase",
    "watermarks", "note_push", "note_pop", "Profiler",
]

DEFAULT_HZ = 67.0        # deliberately co-prime with common 10/50/100 Hz
                         # periodic work, so sampling doesn't alias with it
MAX_DEPTH = 64

# read directly by trace._Span on every span enter — a module-global bool
# is one dict lookup, cheaper than a call when the profiler is off
_ACTIVE = False

_state_lock = threading.Lock()
_folds: dict[str, int] = {}          # collapsed stack -> sample count
_samples = 0                          # total samples folded locally
_span_traces: dict[str, str] = {}     # span name -> last trace_id seen
_watermarks: dict[str, dict] = {}     # phase -> {peak_bytes, count, src}

# tid -> [(span_name, trace_id), ...]; mutated only by the owning thread
# (append/pop are GIL-atomic), read racily by the sampler
_span_stacks: dict[int, list] = {}

_ctl_lock = threading.Lock()
_profiler: Optional["Profiler"] = None
_mem_active = False
_mem_src = "rss"


# -- span attribution (called from repro_torch.obs.trace) -------------------------

def note_push(name: str, trace_id: str = "") -> None:
    """A span opened on this thread (trace._Span calls this only while
    :data:`_ACTIVE`); subsequent samples carry a ``span:<name>`` root."""
    tid = threading.get_ident()
    st = _span_stacks.get(tid)
    if st is None:
        st = _span_stacks[tid] = []
    st.append((name, trace_id))


def note_pop() -> None:
    tid = threading.get_ident()
    st = _span_stacks.get(tid)
    if st:
        st.pop()


# -- the sampler ------------------------------------------------------------

def _frame_label(frame) -> str:
    co = frame.f_code
    return "%s (%s:%d)" % (co.co_name, os.path.basename(co.co_filename),
                           co.co_firstlineno)


def _walk(frame, max_depth: int) -> list[str]:
    """Leaf-first labels for one thread's stack (bounded depth)."""
    out = []
    while frame is not None and len(out) < max_depth:
        out.append(_frame_label(frame))
        frame = frame.f_back
    return out


class Profiler:
    """The daemon sampler thread.  One per process (module :func:`start` /
    :func:`stop` manage the singleton); constructing one directly is the
    embedded/test mode."""

    def __init__(self, hz: float = DEFAULT_HZ, max_depth: int = MAX_DEPTH):
        self.hz = max(float(hz), 0.1)
        self.max_depth = int(max_depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started_unix = 0.0

    def start(self) -> "Profiler":
        if self._thread is not None:
            return self
        self.started_unix = time.time()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-profiler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        own = threading.get_ident()
        while not self._stop.wait(interval):
            if not _metrics.enabled():
                continue
            self._sample_once(own)

    def _sample_once(self, own_tid: int) -> None:
        global _samples
        frames = sys._current_frames()
        ticks: dict[str, int] = {}
        for tid, frame in frames.items():
            if tid == own_tid:
                continue
            stack = _walk(frame, self.max_depth)
            if not stack:
                continue
            stack.reverse()                      # root-first for folding
            st = _span_stacks.get(tid)
            if st:
                try:
                    name, trace_id = st[-1]
                except IndexError:               # raced a pop
                    name = trace_id = ""
                if name:
                    stack.insert(0, "span:" + name)
                    if trace_id:
                        _span_traces[name] = trace_id
            key = ";".join(stack)
            ticks[key] = ticks.get(key, 0) + 1
        # prune span stacks of threads that no longer exist (bounded leak
        # otherwise: one empty list per dead traced thread)
        for tid in [t for t, st in list(_span_stacks.items())
                    if not st and t not in frames]:
            _span_stacks.pop(tid, None)
        if not ticks:
            return
        with _state_lock:
            for key, n in ticks.items():
                _folds[key] = _folds.get(key, 0) + n
                _samples += n


# -- memory watermarks ------------------------------------------------------

def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGESIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except (OSError, ValueError, IndexError):
        try:
            import resource
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            return 0


def _record_watermark(phase: str, peak: int, src: str) -> None:
    with _state_lock:
        w = _watermarks.get(phase)
        if w is None:
            w = _watermarks[phase] = {"peak_bytes": 0, "count": 0, "src": src}
        w["peak_bytes"] = max(int(w["peak_bytes"]), int(peak))
        w["count"] += 1
        w["src"] = src
    # the histogram gives the distribution; the table above the high-water
    # mark the flight recorder dumps
    _metrics.REGISTRY.histogram("mem.phase_peak_bytes",
                                phase=phase).observe(float(peak))


class _MemPhase:
    __slots__ = ("phase", "_tm", "_rss0")

    def __init__(self, phase: str):
        self.phase = phase

    def __enter__(self):
        import tracemalloc
        self._tm = tracemalloc.is_tracing()
        if self._tm:
            try:
                tracemalloc.reset_peak()
            except Exception:        # pre-3.9, or tracing stopped underneath
                self._tm = False
        if not self._tm:
            self._rss0 = _rss_bytes()
        return self

    def __exit__(self, *a):
        if self._tm:
            import tracemalloc
            try:
                peak = tracemalloc.get_traced_memory()[1]
            except Exception:
                return
            _record_watermark(self.phase, peak, "tracemalloc")
        else:
            # RSS high-water of the phase: current RSS at exit vs entry.
            # Coarse (other threads allocate too) but free, and it sees
            # native/numpy buffers tracemalloc cannot.
            _record_watermark(self.phase, max(_rss_bytes(), self._rss0),
                              "rss")


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


_NULL_PHASE = _NullPhase()


def mem_phase(phase: str):
    """Context manager recording the peak memory of a named phase.
    A shared no-op unless memory watermarks are armed (``start(mem=...)``)
    and obs is enabled — a cold call is one flag check."""
    if not _mem_active or not _metrics.enabled():
        return _NULL_PHASE
    return _MemPhase(phase)


def watermarks() -> dict:
    with _state_lock:
        return {k: dict(v) for k, v in _watermarks.items()}


# -- lifecycle --------------------------------------------------------------

def start(hz: float = DEFAULT_HZ, mem=False) -> bool:
    """Start (or restart with new settings) the process profiler.

    ``mem`` arms the watermark layer: ``True``/``"rss"`` records RSS
    peaks, ``"tracemalloc"`` additionally starts tracemalloc for exact
    Python-heap peaks (noticeable allocation overhead — profiling
    sessions, not always-on).  Returns False (and does nothing) when obs
    is disabled."""
    global _profiler, _mem_active, _mem_src, _ACTIVE
    if not _metrics.enabled():
        return False
    with _ctl_lock:
        if _profiler is not None:
            _profiler.stop()
        if mem:
            _mem_src = "tracemalloc" if mem == "tracemalloc" else "rss"
            if _mem_src == "tracemalloc":
                import tracemalloc
                if not tracemalloc.is_tracing():
                    tracemalloc.start()
            _mem_active = True
        _profiler = Profiler(hz=hz).start()
        _ACTIVE = True
    return True


def stop() -> None:
    global _profiler, _mem_active, _ACTIVE
    with _ctl_lock:
        _ACTIVE = False
        p, _profiler = _profiler, None
        if p is not None:
            p.stop()
        if _mem_active and _mem_src == "tracemalloc":
            import tracemalloc
            try:
                tracemalloc.stop()
            except Exception:
                pass
        _mem_active = False


def active() -> bool:
    return _ACTIVE


def status() -> dict:
    with _ctl_lock:
        p = _profiler
        hz = p.hz if p is not None else 0.0
        since = p.started_unix if p is not None else 0.0
    with _state_lock:
        n, stacks = _samples, len(_folds)
    return {"active": _ACTIVE, "hz": hz, "samples": n, "stacks": stacks,
            "mem": _mem_src if _mem_active else None,
            "started_unix": since}


# -- fold export / cross-process folding ------------------------------------

def snapshot(reset: bool = False) -> dict:
    """The profile document: fold table + span trace ids + watermarks.
    ``reset=True`` zeroes the folds/samples (the worker-drain transport);
    watermarks are high-water marks and reset with them."""
    with _state_lock:
        doc = {"version": 1, "samples": _samples, "folds": dict(_folds),
               "span_traces": dict(_span_traces),
               "watermarks": {k: dict(v) for k, v in _watermarks.items()}}
        if reset:
            _reset_locked()
    doc["active"] = _ACTIVE
    return doc


def drain() -> dict:
    """Pop the local profile state (each sample crosses a pool/wire
    boundary exactly once — the ``collect_obs`` / PROF-fetch transport)."""
    return snapshot(reset=True)


def _reset_locked() -> None:
    global _samples
    _folds.clear()
    _samples = 0
    _span_traces.clear()
    _watermarks.clear()


def reset() -> None:
    with _state_lock:
        _reset_locked()


def ingest(doc) -> int:
    """Fold a foreign profile document (a worker's :func:`drain`, a PROF
    fetch) into local state; returns the sample count folded."""
    global _samples
    if not isinstance(doc, dict):
        return 0
    folds = doc.get("folds") or {}
    n = 0
    with _state_lock:
        for key, cnt in folds.items():
            if isinstance(key, str) and isinstance(cnt, int) and cnt > 0:
                _folds[key] = _folds.get(key, 0) + cnt
                n += cnt
        _samples += n
        for name, tid in (doc.get("span_traces") or {}).items():
            if isinstance(name, str) and isinstance(tid, str):
                _span_traces[name] = tid
        for phase, w in (doc.get("watermarks") or {}).items():
            if not isinstance(w, dict):
                continue
            cur = _watermarks.get(phase)
            if cur is None:
                cur = _watermarks[phase] = {"peak_bytes": 0, "count": 0,
                                            "src": w.get("src", "rss")}
            cur["peak_bytes"] = max(int(cur["peak_bytes"]),
                                    int(w.get("peak_bytes", 0)))
            cur["count"] += int(w.get("count", 0))
    return n


# -- exporters --------------------------------------------------------------

def collapsed(doc: Optional[dict] = None) -> str:
    """Brendan-Gregg collapsed-stack text (``stack count`` per line) —
    ``flamegraph.pl`` / speedscope / inferno input."""
    folds = (doc or snapshot()).get("folds") or {}
    return "".join(f"{k} {v}\n" for k, v in sorted(folds.items()))


def speedscope(doc: Optional[dict] = None, name: str = "repro") -> dict:
    """The profile as a speedscope ``sampled`` document (open at
    https://speedscope.app or with ``speedscope file.json``)."""
    folds = (doc or snapshot()).get("folds") or {}
    frame_ix: dict[str, int] = {}
    frames: list[dict] = []
    samples: list[list[int]] = []
    weights: list[int] = []
    total = 0
    for key in sorted(folds):
        cnt = int(folds[key])
        stack = []
        for label in key.split(";"):
            ix = frame_ix.get(label)
            if ix is None:
                ix = frame_ix[label] = len(frames)
                frames.append({"name": label})
            stack.append(ix)
        samples.append(stack)
        weights.append(cnt)
        total += cnt
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled", "name": name, "unit": "none",
            "startValue": 0, "endValue": total,
            "samples": samples, "weights": weights,
        }],
        "name": name, "activeProfileIndex": 0,
        "exporter": "repro_torch.obs.profile",
    }


def self_counts(doc: Optional[dict] = None) -> dict[str, int]:
    """Per-function *self* sample counts (the leaf frame of each fold) —
    what ``obstat --watch`` ranks its top-N functions by."""
    folds = (doc or snapshot()).get("folds") or {}
    out: dict[str, int] = {}
    for key, cnt in folds.items():
        leaf = key.rsplit(";", 1)[-1]
        out[leaf] = out.get(leaf, 0) + int(cnt)
    return out


def write_collapsed(path: str, doc: Optional[dict] = None) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(collapsed(doc))
    os.replace(tmp, path)


def write_speedscope(path: str, doc: Optional[dict] = None,
                     name: str = "repro") -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(speedscope(doc, name=name), f)
    os.replace(tmp, path)

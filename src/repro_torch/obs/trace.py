"""Span-based tracing with Chrome trace-event export and cross-process
causal propagation.

``span("engine.pack", algo="zstd")`` wraps a region of code; completed
spans land in a bounded ring buffer (oldest dropped first, so a
long-running server keeps the *recent* window, which is the one a
``--trace`` capture wants).  :func:`export_chrome` writes the ring as
Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable in
Perfetto / ``chrome://tracing``.

Causality (DESIGN.md §16): when a :mod:`repro_torch.obs.context` span context
is active on the thread — either because an enclosing ``span`` opened
one, or because a server adopted a remote caller's traceparent via
``context.activated(body["tp"])`` — each completed span records
``trace_id`` / ``span_id`` / ``parent_id`` in its ``args`` and pushes
its own context while open, so nested spans (local or remote) chain
into one tree.  Spans opened with no ambient context and without
``root=True`` stay id-free — zero overhead and no
arg noise for purely local tracing.  :func:`stitch` merges captures
from several processes/hosts into one timeline; :func:`build_tree`
reassembles the parent/child forest for assertions and CLI rendering.

Timestamps are microseconds anchored to the unix epoch (wall clock
sampled once at import, advanced by ``perf_counter_ns`` so the timeline
is monotonic within a process).  Same-host captures therefore line up
when stitched; cross-host skew is whatever NTP leaves behind.
Thread-pool workers share the parent's ring; *process*-pool workers
have their own ring that the engine folds back on ``collect_obs()``
via :func:`drain` + :func:`ingest`.  When the ring is full each
appended event evicts the oldest and bumps the ``obs.trace.dropped``
counter.  The enable gate is shared with metrics (``REPRO_OBS=off`` /
:func:`repro_torch.obs.metrics.set_enabled`).

While a ``torch.profiler`` records on the thread, each span also opens a
profiler range of its name (a CPU operation in the profiler's trace, not a
user annotation, so no copy of it lands on the device's timeline).  The
profiler stamps the range on its own clock, the one of the device's
kernels, and on the thread that opened it: each kernel's launch falls
inside the ranges of the spans that issued it, and Perfetto shows the
spans above the kernels.  The ring's own timestamps stay on the clock
above.  With no profiler recording a span pays one check; where ``torch``
was never imported (the storage layer's worker processes) the check is a
dictionary lookup and imports nothing.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from repro_torch.obs import context as _context
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import profile as _profile

__all__ = ["span", "instant", "drain", "events", "export_chrome",
           "set_capacity", "clear", "ingest", "stitch", "build_tree"]

_WALL_US = time.time_ns() / 1e3
_EPOCH_NS = time.perf_counter_ns()
_DEFAULT_CAPACITY = 65536

_lock = threading.Lock()
_ring: deque = deque(maxlen=_DEFAULT_CAPACITY)
_thread_names: dict[int, str] = {}
# the pid, read once a process and again in a forked child: os.getpid() is
# a system call, and on hosts where those are dear it outweighed the rest
# of a span
_pid = os.getpid()


def _refresh_pid() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)


def _now_us() -> float:
    return _WALL_US + (time.perf_counter_ns() - _EPOCH_NS) / 1e3


def set_capacity(n: int) -> None:
    """Resize the ring (keeps the newest events)."""
    global _ring
    with _lock:
        _ring = deque(_ring, maxlen=int(n))


def clear() -> None:
    with _lock:
        _ring.clear()


def _note_thread() -> int:
    t = threading.current_thread()
    tid = t.ident or 0
    if tid not in _thread_names:
        _thread_names[tid] = t.name
    return tid


def _append(ev: dict) -> None:
    """Ring append with eviction accounting (caller must NOT hold _lock)."""
    dropped = False
    with _lock:
        if _ring.maxlen is not None and len(_ring) >= _ring.maxlen:
            dropped = True
        _ring.append(ev)
    if dropped:
        _metrics.REGISTRY.counter("obs.trace.dropped").inc()


def _profiler_range(name: str):
    """An entered profiler range named ``name`` while a ``torch.profiler``
    records on this thread, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    r = torch._C._profiler._RecordFunctionFast(name)
    r.__enter__()
    return r


class _Span:
    __slots__ = ("name", "cat", "args", "_t0", "_ctx", "_parent", "_prof",
                 "_range")

    def __init__(self, name: str, cat: str, args: dict, root: bool):
        self.name = name
        self.cat = cat
        self.args = args
        parent = _context.current()
        if parent is not None:
            self._ctx = parent.child()
            self._parent = parent.span_id
        elif root:
            self._ctx = _context.SpanContext(
                _context.new_trace_id(), _context.new_span_id())
            self._parent = None
        else:
            self._ctx = None
            self._parent = None

    def __enter__(self):
        if self._ctx is not None:
            _context.push(self._ctx)
        # span-attributed profiling (§17): while the sampler runs, register
        # this span on the thread so samples carry a span:<name> root frame.
        # The flag is latched per span — a profiler started mid-span must
        # not pop what was never pushed.
        self._prof = _profile._ACTIVE
        if self._prof:
            _profile.note_push(
                self.name,
                self._ctx.trace_id if self._ctx is not None else "")
        self._t0 = _now_us()
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        t1 = _now_us()
        if self._prof:
            _profile.note_pop()
        if self._ctx is not None:
            _context.pop()
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        ev = {"name": self.name, "cat": self.cat, "ph": "X",
              "ts": self._t0, "dur": t1 - self._t0,
              "pid": _pid, "tid": _note_thread()}
        if self._ctx is not None:
            ids = {"trace_id": self._ctx.trace_id,
                   "span_id": self._ctx.span_id}
            if self._parent is not None:
                ids["parent_id"] = self._parent
            self.args = dict(self.args, **ids)
        if self.args:
            ev["args"] = self.args
        _append(ev)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, cat: str = "repro", root: bool = False, **args):
    """Context manager recording one complete ("X") trace event.

    ``root=True`` mints a fresh trace when no context is active (the
    client entry points use this so propagation works without callers
    having to open their own root span); with an ambient context the
    span is its child either way."""
    if not _metrics.enabled():
        return _NULL_SPAN
    return _Span(name, cat, args, root)


def instant(name: str, cat: str = "repro", **args) -> None:
    """Record a zero-duration marker event."""
    if not _metrics.enabled():
        return
    ctx = _context.current()
    if ctx is not None:
        args = dict(args, trace_id=ctx.trace_id, parent_id=ctx.span_id)
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
          "ts": _now_us(), "pid": _pid, "tid": _note_thread()}
    if args:
        ev["args"] = args
    _append(ev)


def events() -> list[dict]:
    """Copy of the current ring (oldest first), ring left intact."""
    with _lock:
        return list(_ring)


def drain() -> list[dict]:
    """Pop every buffered event (the STATS-verb transport: each event
    crosses the wire exactly once)."""
    with _lock:
        out = list(_ring)
        _ring.clear()
    return out


def ingest(evs: list) -> int:
    """Fold foreign events (a process-pool worker's drained ring) into
    this process's ring; returns the count folded."""
    n = 0
    for ev in evs or ():
        if isinstance(ev, dict):
            _append(ev)
            n += 1
    return n


def stitch(*captures) -> list[dict]:
    """Merge trace captures from several processes into one timeline.

    Each capture is a list of events or a ``{"traceEvents": [...]}``
    dict (an :func:`export_chrome` document).  Metadata ("M") events are
    deduplicated by (pid, tid, name); real events sort by timestamp.
    Because timestamps are unix-anchored, same-host captures interleave
    correctly without offset fixups."""
    meta: dict[tuple, dict] = {}
    evs: list[dict] = []
    for cap in captures:
        if isinstance(cap, dict):
            cap = cap.get("traceEvents") or []
        for ev in cap:
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M":
                meta.setdefault(
                    (ev.get("pid"), ev.get("tid"), ev.get("name")), ev)
            else:
                evs.append(ev)
    evs.sort(key=lambda e: e.get("ts", 0.0))
    return [meta[k] for k in sorted(meta, key=str)] + evs


def build_tree(evs: list[dict]) -> list[dict]:
    """Reassemble the span forest from propagated ids.

    Returns roots as ``{"name", "event", "children": [...]}`` nodes
    (children ordered by start time).  Events without a ``span_id`` are
    ignored; events whose ``parent_id`` is absent from the capture
    (parent fell off a ring, or the capture window clipped it) become
    roots so nothing silently vanishes."""
    nodes: dict[str, dict] = {}
    order: list[dict] = []
    for ev in sorted(evs, key=lambda e: e.get("ts", 0.0)):
        args = ev.get("args") or {}
        sid = args.get("span_id")
        if not sid:
            continue
        node = {"name": ev.get("name"), "event": ev, "children": []}
        nodes[sid] = node
        order.append(node)
    roots = []
    for node in order:
        pid = (node["event"].get("args") or {}).get("parent_id")
        parent = nodes.get(pid) if pid else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def export_chrome(path: str, events: Optional[list] = None) -> int:
    """Write Chrome trace-event JSON; returns the event count.

    ``events=None`` drains the live ring; passing an explicit list (e.g.
    one shipped over STATS, or a synthetic one in tests) exports that
    instead.  Thread-name metadata ("M" events) is emitted for every tid
    seen so Perfetto shows "prefetch-0" instead of a bare id."""
    evs = drain() if events is None else list(events)
    tids = {(e.get("pid"), e.get("tid"))
            for e in evs if "tid" in e and e.get("ph") != "M"}
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": _thread_names.get(tid, f"tid-{tid}")}}
            for pid, tid in sorted(tids, key=lambda x: (str(x[0]), str(x[1])))]
    doc = {"traceEvents": meta + evs, "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(evs)

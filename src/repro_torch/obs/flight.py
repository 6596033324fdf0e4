"""Crash flight recorder: the stack's black box (DESIGN.md §17).

A :class:`FlightRecorder` keeps a bounded ring of recent metric
snapshots (one per ``interval_s`` tick, ``capacity`` deep) and, when the
process dies — unhandled exception, SIGTERM, or an explicit
:func:`trigger` — dumps a post-mortem bundle: the snapshot ring, the
final registry state, the trace ring, every thread's live stack with its
active span, the profiler's folds and memory watermarks, and SLO
verdicts if an engine is attached.  ``python -m repro_torch.obs --postmortem
bundle.json`` renders it.

Dumping is the crash path, so it must never make the crash worse: every
collection step is individually best-effort (a failure in one section
drops that section, not the bundle), the bundle writes tmp → rename, and
the previously-installed excepthook / SIGTERM handler still runs after
the dump — the recorder observes the death, it does not change it.

The *ticker* honors the ``REPRO_OBS`` gate (a disabled process records
no snapshots), but :func:`dump` itself always works — post-mortem
evidence from a crashing process is wanted precisely when everything
else is going wrong.

Bundle destination: explicit ``path`` > recorder ``dir`` >
``$REPRO_FLIGHT_DIR`` > ``artifacts/flight``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from repro_torch.obs import context as _context
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import profile as _profile
from repro_torch.obs import trace as _trace

__all__ = ["FlightRecorder", "install", "uninstall", "trigger", "recorder",
           "load_bundle", "DEFAULT_DIR_ENV"]

DEFAULT_DIR_ENV = "REPRO_FLIGHT_DIR"
BUNDLE_KIND = "repro-flight"

_ctl_lock = threading.Lock()
_recorder: Optional["FlightRecorder"] = None


def _best_effort(fn, default=None):
    try:
        return fn()
    except Exception:
        return default


class FlightRecorder:
    """One per process.  ``install()`` arms the death hooks; ``tick()``
    (or the background ticker started by ``start()``) feeds the ring."""

    def __init__(self, dir: Optional[str] = None, interval_s: float = 1.0,
                 capacity: int = 120, slo=None):
        self.dir = dir
        self.interval_s = max(float(interval_s), 0.05)
        self.slo = slo                       # an SLOEngine, or None
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._installed = False
        self._dumped = False                 # one bundle per death, not two

    # -- the ring --------------------------------------------------------

    def tick(self) -> None:
        """Append one metrics snapshot to the ring (no-op when obs is
        disabled — the ticker must not resurrect a gated registry)."""
        if not _metrics.enabled():
            return
        snap = _best_effort(lambda: _metrics.REGISTRY.snapshot())
        if snap is None:
            return
        with self._lock:
            self._ring.append({"ts": time.time(), "metrics": snap})

    def start(self) -> "FlightRecorder":
        """Start the background ticker thread (daemon)."""
        if self._thread is not None:
            return self

        def _run():
            while not self._stop.wait(self.interval_s):
                self.tick()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="obs-flight")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    # -- death hooks -----------------------------------------------------

    def install(self) -> "FlightRecorder":
        """Chain ``sys.excepthook`` and (main thread only) SIGTERM.  The
        previous hooks still run after the dump."""
        if self._installed:
            return self
        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.dump("unhandled-exception", exc=(exc_type, exc, tb))
            prev = self._prev_excepthook or sys.__excepthook__
            prev(exc_type, exc, tb)

        sys.excepthook = _hook
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_term)
        except ValueError:       # not the main thread: excepthook-only mode
            self._prev_sigterm = None
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
        self._installed = False

    def _on_term(self, signum, frame) -> None:
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # re-deliver with the default disposition so the exit status
            # still says "killed by SIGTERM"
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)
                return
            except (OSError, ValueError):
                pass
            raise SystemExit(128 + int(signum))
        else:
            raise SystemExit(128 + int(signum))

    # -- the bundle ------------------------------------------------------

    def _out_path(self, path: Optional[str]) -> str:
        if path:
            return path
        d = self.dir or os.environ.get(DEFAULT_DIR_ENV) or "artifacts/flight"
        return os.path.join(
            d, f"flight-{os.getpid()}-{int(time.time() * 1000)}.json")

    def _threads_table(self) -> list[dict]:
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = getattr(_profile, "_span_stacks", {})
        out = []
        for tid, frame in sys._current_frames().items():
            row: dict = {"tid": tid, "name": names.get(tid, f"tid-{tid}")}
            row["stack"] = _best_effort(
                lambda: traceback.format_stack(frame), [])
            st = stacks.get(tid)
            if st:
                try:
                    name, trace_id = st[-1]
                    row["span"] = name
                    if trace_id:
                        row["trace_id"] = trace_id
                except (IndexError, ValueError):
                    pass
            out.append(row)
        return out

    def build_bundle(self, reason: str, exc=None) -> dict:
        """Assemble (but do not write) the post-mortem document.  Every
        section is individually best-effort."""
        with self._lock:
            snaps = list(self._ring)
        doc: dict = {
            "version": 1, "kind": BUNDLE_KIND, "reason": reason,
            "ts": time.time(), "pid": os.getpid(),
            "argv": _best_effort(lambda: list(sys.argv), []),
            "snapshots": snaps,
            "final_metrics": _best_effort(
                lambda: _metrics.REGISTRY.snapshot(), {}),
            "trace_events": _best_effort(lambda: _trace.events(), []),
            "threads": _best_effort(self._threads_table, []),
            "profile": _best_effort(lambda: _profile.snapshot(), {}),
            "watermarks": _best_effort(_profile.watermarks, {}),
        }
        if exc is not None:
            exc_type, exc_val, tb = exc
            doc["exception"] = {
                "type": getattr(exc_type, "__name__", str(exc_type)),
                "message": _best_effort(lambda: str(exc_val), ""),
                "traceback": _best_effort(
                    lambda: traceback.format_exception(exc_type, exc_val,
                                                       tb), []),
            }
        if self.slo is not None:
            doc["slo"] = _best_effort(self.slo.evaluate, None)
        tp = _best_effort(_context.current_traceparent)
        if tp:
            doc["traceparent"] = tp
        return doc

    def dump(self, reason: str, path: Optional[str] = None,
             exc=None, force: bool = False) -> Optional[str]:
        """Write the bundle; returns its path (None if the write failed —
        the crash path never raises).  A recorder dumps once per process
        death; ``force=True`` (the explicit-trigger path) always dumps."""
        with self._lock:
            if self._dumped and not force:
                return None
            self._dumped = not force
        out = self._out_path(path)
        try:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            doc = self.build_bundle(reason, exc=exc)
            tmp = f"{out}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, out)
        except Exception:
            return None
        sys.stderr.write(f"[repro_torch.obs.flight] {reason}: wrote {out}\n")
        return out


# -- module-level singleton --------------------------------------------------

def install(dir: Optional[str] = None, interval_s: float = 1.0,
            capacity: int = 120, slo=None,
            ticker: bool = True) -> FlightRecorder:
    """Arm the process flight recorder (idempotent: a second call returns
    the existing one)."""
    global _recorder
    with _ctl_lock:
        if _recorder is not None:
            return _recorder
        rec = FlightRecorder(dir=dir, interval_s=interval_s,
                             capacity=capacity, slo=slo).install()
        if ticker:
            rec.start()
        _recorder = rec
        return rec


def uninstall() -> None:
    """Disarm and drop the singleton (tests must not leak hooks into the
    harness)."""
    global _recorder
    with _ctl_lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.stop()
        rec.uninstall()


def recorder() -> Optional[FlightRecorder]:
    return _recorder


def trigger(reason: str = "manual",
            path: Optional[str] = None) -> Optional[str]:
    """Dump a bundle right now (installing a recorder on the fly if none
    is armed) — the operator's "capture the current state" hook."""
    rec = _recorder
    if rec is None:
        rec = FlightRecorder()
        rec.tick()
    return rec.dump(reason, path=path, force=True)


def load_bundle(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != BUNDLE_KIND:
        raise ValueError(f"{path} is not a {BUNDLE_KIND} bundle "
                         f"(kind={doc.get('kind')!r})")
    return doc

"""repro_torch.obs — unified metrics, tracing, and access telemetry.

The observability layer for the whole stack (DESIGN.md §13, §16): a
process-wide lock-cheap metrics registry (:mod:`repro_torch.obs.metrics`),
span tracing with Chrome trace-event export and cross-process
traceparent propagation (:mod:`repro_torch.obs.trace`,
:mod:`repro_torch.obs.context`), a persistent access-heat log
(:mod:`repro_torch.obs.heat`), rolling-window SLOs (:mod:`repro_torch.obs.slo`),
a continuous sampling profiler with span-attributed flamegraphs and
memory watermarks (:mod:`repro_torch.obs.profile`), a crash flight recorder
(:mod:`repro_torch.obs.flight`), and RBSP ``STATS``/``PROF`` views served by
:class:`repro_torch.remote.BasketServer` and read by ``python -m repro_torch.obs``
/ ``tools/obstat.py``.

Call-site idiom — acquire the instrument *per event* through the helpers
here, so the ``REPRO_OBS`` gate (env at import, runtime via
:func:`set_enabled`) applies immediately and a disabled site costs one
flag check plus a no-op call::

    from repro_torch import obs

    obs.counter("server.reads", branch=name).inc()
    with obs.histogram("engine.pack_s", algo=cfg.algo).time():
        ...
    with obs.trace.span("ckpt.save", step=step):
        ...

Default-on: instruments are live unless ``REPRO_OBS=off``.  The CI
overhead gate (benchmarks/fig_obs.py) holds the instrumented fig_zerocopy
quick run within 2% of the disabled run.
"""

from __future__ import annotations

from repro_torch.obs import context, flight, metrics, profile, trace
from repro_torch.obs.metrics import (
    NULL, REGISTRY, Registry,
    enabled, set_enabled, format_key, parse_key, quantile_from_buckets,
    exemplar_for_quantile,
)

__all__ = [
    "metrics", "trace", "context", "profile", "flight",
    "REGISTRY", "Registry", "NULL",
    "counter", "gauge", "histogram", "snapshot", "merge",
    "enabled", "set_enabled", "format_key", "parse_key",
    "quantile_from_buckets", "exemplar_for_quantile",
]


def counter(name: str, **labels):
    """Process-wide counter (no-op instrument when obs is disabled)."""
    if not metrics.enabled():
        return NULL
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels):
    if not metrics.enabled():
        return NULL
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels):
    if not metrics.enabled():
        return NULL
    return REGISTRY.histogram(name, **labels)


def snapshot(reset: bool = False) -> dict:
    """Snapshot of the process-wide registry (see Registry.snapshot)."""
    return REGISTRY.snapshot(reset=reset)


def merge(snap: dict) -> None:
    """Fold a worker's delta snapshot into the process-wide registry."""
    REGISTRY.merge(snap)

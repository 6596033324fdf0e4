"""obstat — the observability CLI (``python -m repro_torch.obs``).

Modes against a live :class:`repro_torch.remote.BasketServer` (over the RBSP
``STATS``/``PROF`` verbs — no container path needed, just host:port):

one-shot dump (default)::

    python -m repro_torch.obs HOST:PORT            # rendered
    python -m repro_torch.obs HOST:PORT --json     # raw snapshot JSON

watch (top-N hot branches + per-verb request latency, delta per tick)::

    python -m repro_torch.obs HOST:PORT --watch [--top 10] [--interval 2]

trace capture window (drain, wait, drain -> Chrome trace JSON)::

    python -m repro_torch.obs HOST:PORT --trace out.json [--duration 5]

continuous profiling (DESIGN.md §17; ``capture`` = start, wait
``--duration``, fetch, stop — one-shot flamegraph)::

    python -m repro_torch.obs HOST:PORT --prof capture --prof-out flame.folded
    python -m repro_torch.obs HOST:PORT --prof start [--hz 67] [--mem]
    python -m repro_torch.obs HOST:PORT --prof fetch --prof-out prof.speedscope.json
    python -m repro_torch.obs HOST:PORT --prof stop

stitch multi-process captures into one timeline (DESIGN.md §16)::

    python -m repro_torch.obs --stitch merged.json client.json server.json

render a crash flight-recorder bundle (no target needed)::

    python -m repro_torch.obs --postmortem artifacts/flight/flight-123.json

Without a target, the one-shot mode dumps *this* process's registry —
mostly useful under ``python -m repro_torch.obs --json`` in scripts and tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.obs import REGISTRY, metrics, profile, trace

# what --watch renders: poll only these prefixes instead of shipping the
# whole registry each tick (the STATS "filter" key; bare polls unchanged)
WATCH_PREFIXES = ["server.", "remote.", "repair.", "bfile.", "obs."]


def _parse_target(target: str) -> tuple[str, int]:
    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"target must be HOST:PORT, got {target!r}")
    return host, int(port)


def _fetch(target: str, want_trace: bool = False, filter=None,
           want_profile: bool = False) -> dict:
    from repro_torch.remote.client import fetch_stats
    host, port = _parse_target(target)
    return fetch_stats(host, port, trace=want_trace, filter=filter,
                       profile=want_profile)


def _hist_stats(h: dict) -> tuple[int, float, float, float]:
    n = int(h.get("count", 0))
    mean = h.get("sum", 0.0) / n if n else 0.0
    b = h.get("buckets", {})
    s = h.get("bsums")
    return (n, mean, metrics.quantile_from_buckets(b, 0.50, s),
            metrics.quantile_from_buckets(b, 0.99, s))


def _hist_delta(cur: dict, prev: dict) -> dict:
    """Per-tick histogram delta (counts can only grow)."""
    pb = prev.get("buckets", {})
    ps = prev.get("bsums", {})
    buckets = {k: int(v) - int(pb.get(k, 0))
               for k, v in cur.get("buckets", {}).items()
               if int(v) - int(pb.get(k, 0)) > 0}
    bsums = {k: float(cur.get("bsums", {}).get(k, 0.0))
             - float(ps.get(k, 0.0)) for k in buckets}
    d = {"count": int(cur.get("count", 0)) - int(prev.get("count", 0)),
         "sum": float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0)),
         "buckets": buckets, "bsums": bsums}
    if cur.get("exemplars"):
        d["exemplars"] = cur["exemplars"]
    return d


def hot_branches(counters: dict, prev: dict, top: int) -> list[tuple]:
    """Top-N ``server.reads{...}`` rows by this tick's delta (total read
    count breaks ties, so a cold tick still shows the historical ranking).
    Returns ``[(branch, path, delta, total), ...]``."""
    rows = []
    for key, total in counters.items():
        name, labels = metrics.parse_key(key)
        if name != "server.reads":
            continue
        delta = int(total) - int(prev.get(key, 0))
        rows.append((labels.get("branch", "?"), labels.get("path", "?"),
                     delta, int(total)))
    rows.sort(key=lambda r: (-r[2], -r[3], r[0]))
    return rows[:top]


def fault_rows(counters: dict, prev: dict) -> list[tuple[str, int, int]]:
    """The robustness counters (DESIGN.md §14) as ``(label, delta, total)``
    rows — retries by reason, hedges by outcome, server sheds and idle
    reaps, corrupt-basket quarantines.  Zero-total rows are omitted; a
    healthy system shows nothing here."""
    want = ("remote.retries", "remote.hedge", "server.shed",
            "server.idle_closed", "bfile.corrupt_baskets")
    rows = []
    for key, total in counters.items():
        name, labels = metrics.parse_key(key)
        if name not in want:
            continue
        label = name + "".join(f"[{v}]" for _k, v in sorted(labels.items()))
        rows.append((label, int(total) - int(prev.get(key, 0)), int(total)))
    rows.sort(key=lambda r: (-r[1], -r[2], r[0]))
    return rows


def repair_rows(counters: dict, prev: dict) -> list[tuple[str, int, int]]:
    """Self-healing activity (DESIGN.md §15) as ``(label, delta, total)``
    rows — every counter under the ``repair.`` prefix: in-place heals,
    transient re-read saves, heal failures, scrub progress/finds, and
    anti-entropy pulls.  Zero-total rows are omitted."""
    rows = []
    for key, total in counters.items():
        name, labels = metrics.parse_key(key)
        if not name.startswith("repair."):
            continue
        label = name + "".join(f"[{v}]" for _k, v in sorted(labels.items()))
        rows.append((label, int(total) - int(prev.get(key, 0)), int(total)))
    rows.sort(key=lambda r: (-r[1], -r[2], r[0]))
    return rows


def profiler_rows(prof: dict, prev_prof: dict,
                  top: int) -> list[tuple[str, int, int]]:
    """Top-N functions by *self*-sample delta this tick (total self
    samples breaks ties) from the STATS ``profile.self`` table —
    ``[(function, delta, total), ...]``.  Empty when the profiler is off
    or has no samples, so the section hides like faults/self-healing."""
    if not prof or not prof.get("active"):
        return []
    cur = prof.get("self") or {}
    prev = (prev_prof or {}).get("self") or {}
    rows = [(fn, int(total) - int(prev.get(fn, 0)), int(total))
            for fn, total in cur.items()]
    rows.sort(key=lambda r: (-r[1], -r[2], r[0]))
    return rows[:top]


def _render_watch(snap: dict, prev_snap: dict, body: dict, top: int,
                  interval: float, prev_prof: dict = {}) -> str:
    lines = [f"repro_torch.obs watch — gen {body.get('gen')} pid {body.get('pid')} "
             f"uptime {body.get('uptime_s', 0.0):.0f}s "
             f"(tick {interval:g}s)"]
    srv = body.get("server") or {}
    if srv:
        lines.append("  " + "  ".join(f"{k}={v}" for k, v in sorted(srv.items())))
    faults = fault_rows(snap.get("counters", {}),
                        prev_snap.get("counters", {}))
    if faults:
        lines.append("")
        lines.append("  faults/degradation (delta per tick):")
        for label, delta, total in faults:
            lines.append(f"    {label:<40} +{delta:<8} total {total}")
    repairs = repair_rows(snap.get("counters", {}),
                          prev_snap.get("counters", {}))
    if repairs:
        lines.append("")
        lines.append("  self-healing (delta per tick):")
        for label, delta, total in repairs:
            lines.append(f"    {label:<40} +{delta:<8} total {total}")
    lines.append("")
    lines.append(f"  hot branches (top {top}, reads/tick):")
    rows = hot_branches(snap.get("counters", {}),
                        prev_snap.get("counters", {}), top)
    if not rows:
        lines.append("    (no reads yet)")
    for branch, path, delta, total in rows:
        lines.append(f"    {branch:<24} {path:<28} +{delta:<8} total {total}")
    lines.append("")
    lines.append("  request latency (per verb, this tick):")
    hists = snap.get("hists", {})
    prev_h = prev_snap.get("hists", {})
    any_verb = False
    for key in sorted(hists):
        name, labels = metrics.parse_key(key)
        if name != "server.request_s":
            continue
        d = _hist_delta(hists[key], prev_h.get(key, {}))
        src = d if d["count"] else hists[key]
        n, mean, p50, p99 = _hist_stats(src)
        scope = "tick" if d["count"] else "all"
        ex = metrics.exemplar_for_quantile(src, 0.99)
        ex_s = f" ex={ex['trace_id'][:12]}" if ex else ""
        lines.append(f"    {labels.get('verb', '?'):<8} n={n:<7} ({scope}) "
                     f"mean={mean * 1e3:.3f}ms p50={p50 * 1e3:.3f}ms "
                     f"p99={p99 * 1e3:.3f}ms{ex_s}")
        any_verb = True
    if not any_verb:
        lines.append("    (no requests yet)")
    prof = body.get("profile") or {}
    prows = profiler_rows(prof, prev_prof, top)
    if prows:
        lines.append("")
        lines.append(f"  profiler (self samples/tick, {prof.get('hz', 0):g} Hz, "
                     f"{prof.get('samples', 0)} total):")
        for fn, delta, total in prows:
            lines.append(f"    {fn:<56} +{delta:<8} total {total}")
    slo = body.get("slo")
    if slo:
        lines.append("")
        lines.append("  SLO (rolling window):")
        for v in slo:
            status = "OK " if v.get("ok") else "VIOLATED"
            parts = [f"    {v.get('name', '?'):<20} {status}"]
            if "p99_s" in v:
                parts.append(f"p99={v['p99_s'] * 1e3:.3f}ms"
                             f"/{v['p99_limit_s'] * 1e3:.0f}ms")
            if "error_rate" in v:
                parts.append(f"err={v['errors']}/{v['requests']}"
                             f" burn={v.get('burn', 0.0):.2f}x")
            parts.append(f"span={v.get('span_s', 0.0):.1f}s")
            lines.append(" ".join(parts))
    return "\n".join(lines)


def _render_postmortem(doc: dict) -> str:
    """Human-readable view of a flight-recorder bundle (DESIGN.md §17)."""
    lines = [f"repro flight recorder — {doc.get('reason', '?')}",
             f"  pid {doc.get('pid')}  ts {doc.get('ts', 0.0):.3f}  "
             f"argv {' '.join(doc.get('argv') or []) or '?'}"]
    exc = doc.get("exception")
    if exc:
        lines.append("")
        lines.append(f"  exception: {exc.get('type')}: {exc.get('message')}")
        for ln in "".join(exc.get("traceback") or []).rstrip().splitlines():
            lines.append(f"    {ln}")
    threads = doc.get("threads") or []
    if threads:
        lines.append("")
        lines.append(f"  threads at death ({len(threads)}):")
        for t in threads:
            span = f"  span={t['span']}" if t.get("span") else ""
            tid = f" trace={t['trace_id'][:12]}" if t.get("trace_id") else ""
            lines.append(f"    {t.get('name', '?')}{span}{tid}")
            tail = (t.get("stack") or [])[-2:]
            for frame in "".join(tail).rstrip().splitlines():
                lines.append(f"      {frame.strip()}")
    prof = doc.get("profile") or {}
    selfs = sorted(profile.self_counts(prof).items(),
                   key=lambda kv: -kv[1])[:10]
    if selfs:
        lines.append("")
        lines.append(f"  profile ({prof.get('samples', 0)} samples, "
                     f"top self):")
        for fn, n in selfs:
            lines.append(f"    {fn:<56} {n}")
    marks = doc.get("watermarks") or {}
    if marks:
        lines.append("")
        lines.append("  memory watermarks:")
        for phase, w in sorted(marks.items()):
            lines.append(f"    {phase:<24} peak {w.get('peak_bytes', 0):>12} B"
                         f"  x{w.get('count', 0)} ({w.get('src', '?')})")
    slo = doc.get("slo")
    if slo:
        lines.append("")
        lines.append("  SLO verdicts at death:")
        for v in slo:
            status = "OK " if v.get("ok") else "VIOLATED"
            lines.append(f"    {v.get('name', '?'):<20} {status}")
    n_snap = len(doc.get("snapshots") or [])
    n_ev = len(doc.get("trace_events") or [])
    counters = (doc.get("final_metrics") or {}).get("counters") or {}
    lines.append("")
    lines.append(f"  ring: {n_snap} metric snapshots, {n_ev} trace events, "
                 f"{len(counters)} counters at death")
    return "\n".join(lines)


def _run_prof(target: str, action: str, hz: float, mem: bool,
              duration: float, out: str | None) -> int:
    """The --prof mode: drive a live server's sampling profiler over the
    PROF verb.  ``capture`` is the one-shot flamegraph: start, sample for
    ``duration``, fetch+reset, stop, export."""
    from repro_torch.remote.client import request_prof
    host, port = _parse_target(target)
    kw = {"hz": hz or None, "mem": mem}
    if action == "capture":
        request_prof(host, port, action="start", **kw)
        time.sleep(duration)
        body = request_prof(host, port, action="fetch", reset=True)
        request_prof(host, port, action="stop")
    elif action == "fetch":
        body = request_prof(host, port, action="fetch")
    elif action in ("start", "stop", "status"):
        body = request_prof(host, port, action=action, **kw)
        print(json.dumps(body.get("profile") or body, sort_keys=True))
        return 0
    else:
        raise SystemExit(f"unknown --prof action {action!r}")
    doc = body.get("profile") or {}
    if out:
        if out.endswith(".json"):
            profile.write_speedscope(out, doc, name=target)
        else:
            profile.write_collapsed(out, doc)
        print(f"wrote {doc.get('samples', 0)} samples "
              f"({len(doc.get('folds') or {})} stacks) to {out}")
    else:
        sys.stdout.write(profile.collapsed(doc))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="dump / watch / trace repro observability "
                    "(RBSP STATS verb)")
    ap.add_argument("target", nargs="?", default=None,
                    help="HOST:PORT of a live BasketServer "
                         "(omit: dump this process's registry)")
    ap.add_argument("--json", action="store_true",
                    help="raw snapshot JSON instead of rendered text")
    ap.add_argument("--watch", action="store_true",
                    help="refresh a top-N hot-branch / latency view")
    ap.add_argument("--top", type=int, default=10, metavar="N",
                    help="branches shown in --watch (default 10)")
    ap.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="--watch poll period (default 2s)")
    ap.add_argument("--count", type=int, default=0, metavar="N",
                    help="stop --watch after N ticks (0 = forever)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="capture a span window to Chrome trace JSON")
    ap.add_argument("--duration", type=float, default=5.0, metavar="S",
                    help="--trace capture window (default 5s)")
    ap.add_argument("--stitch", nargs="+", metavar="JSON", default=None,
                    help="OUT.json CAPTURE.json [CAPTURE.json ...]: merge "
                         "per-process Chrome captures into one timeline")
    ap.add_argument("--prof", metavar="ACTION", default=None,
                    choices=["start", "stop", "status", "fetch", "capture"],
                    help="drive the server's sampling profiler over the "
                         "PROF verb (capture = start/wait --duration/"
                         "fetch/stop)")
    ap.add_argument("--hz", type=float, default=0.0,
                    help="--prof start/capture sample rate "
                         "(default: server default)")
    ap.add_argument("--mem", action="store_true",
                    help="--prof start/capture: arm memory watermarks")
    ap.add_argument("--prof-out", metavar="OUT", default=None,
                    help="--prof fetch/capture output (*.json = speedscope, "
                         "else collapsed stacks; default: stdout)")
    ap.add_argument("--postmortem", metavar="BUNDLE.json", default=None,
                    help="render a crash flight-recorder bundle "
                         "(--json dumps it raw)")
    args = ap.parse_args(argv)

    if args.postmortem is not None:
        from repro_torch.obs import flight
        doc = flight.load_bundle(args.postmortem)
        if args.json:
            json.dump(doc, sys.stdout, sort_keys=True)
            print()
        else:
            print(_render_postmortem(doc))
        return 0

    if args.prof is not None:
        if args.target is None:
            ap.error("--prof needs a HOST:PORT target")
        return _run_prof(args.target, args.prof, args.hz, args.mem,
                         args.duration, args.prof_out)

    if args.stitch is not None:
        if len(args.stitch) < 2:
            ap.error("--stitch needs OUT.json plus at least one capture")
        out_path, inputs = args.stitch[0], args.stitch[1:]
        caps = []
        for path in inputs:
            with open(path) as f:
                caps.append(json.load(f))
        merged = trace.stitch(*caps)
        n = trace.export_chrome(out_path, events=merged)
        print(f"stitched {len(inputs)} captures -> {n} events "
              f"in {out_path}")
        return 0

    if args.trace is not None:
        if args.target is None:
            time.sleep(args.duration)
            n = trace.export_chrome(args.trace)
        else:
            _fetch(args.target, want_trace=True)     # discard pre-window
            time.sleep(args.duration)
            body = _fetch(args.target, want_trace=True)
            n = trace.export_chrome(args.trace,
                                    events=body.get("trace_events") or [])
        print(f"wrote {n} trace events to {args.trace}")
        return 0

    if args.watch:
        if args.target is None:
            ap.error("--watch needs a HOST:PORT target")
        prev: dict = {}
        prev_prof: dict = {}
        tick = 0
        try:
            while True:
                body = _fetch(args.target, filter=WATCH_PREFIXES,
                              want_profile=True)
                snap = body.get("metrics") or {}
                out = _render_watch(snap, prev, body, args.top,
                                    args.interval, prev_prof)
                # ANSI clear+home when interactive; plain append otherwise
                if sys.stdout.isatty():
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(out, flush=True)
                prev = snap
                prev_prof = body.get("profile") or {}
                tick += 1
                if args.count and tick >= args.count:
                    return 0
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0

    if args.target is None:
        snap = REGISTRY.snapshot()
        body = {"metrics": snap}
    else:
        body = _fetch(args.target)
        snap = body.get("metrics") or {}
    if args.json:
        json.dump(body, sys.stdout, sort_keys=True)
        print()
    else:
        if "gen" in body:
            print(f"# gen {body['gen']} pid {body.get('pid')} "
                  f"uptime {body.get('uptime_s', 0.0):.0f}s")
        for k, v in sorted((body.get("server") or {}).items()):
            print(f"server.{k} {v}")
        rendered = REGISTRY.render(snap)
        if rendered:
            print(rendered)
    return 0


if __name__ == "__main__":
    sys.exit(main())

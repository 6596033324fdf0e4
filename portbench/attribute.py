"""Charges a traced window's device work and idle time to the program's
ranges.

While ``torch.profiler`` records, each ``repro_torch.obs`` span opens a
profiler range of its name on the thread that opened it (a CPU operation
in the trace, on the device trace's clock).  From the profiler's raw
events and the names of the spans the window recorded:

* a device operation (not a device-side copy of a user annotation) is
  charged to the path of program ranges open at its launch (its CUDA
  runtime call, matched by correlation id): the ranges the driving thread
  (the one that opened ``portbench.window``) has open then, followed, for
  a launch from another thread, by that thread's own (autograd's device
  thread launches the backward and the recompute);
* each piece of device-idle time goes to the path of the innermost
  program range the driving thread has open then;
* an idle gap is named, as ``harness.analyse_trace`` names it, by the
  innermost range on the driving thread at its midpoint: the harness's
  label or the program range's path.

A path joins range names outermost first with ``/``
(``serve.prefill/model.attention``); ``""`` is work outside every program
range, ``"?"`` a device operation whose launch the trace lacks.

    python3 portbench/attribute.py --workload <cell> --seed <n> --seconds <s> [--trace 0]

runs the cell's driver (set-up and window, no check against the reference)
and prints one JSON line: the end-to-end values, the spans the window
recorded (count and host ms), and traced (the default) the ranges, the idle
gaps, the harness's own reading of the same trace and ``readings``, the
per-layer numbers read from the ranges.
"""

from __future__ import annotations

import bisect
import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = "portbench.window"
OUTSIDE = "host, outside the calls"
# CUDA runtime and driver calls that put work on a stream
_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
             "cuMemset", "cudaGraphLaunch")


class _Thread:
    """One host thread's ranges, properly nested, as (start, end, label,
    program) tuples: the innermost one open at a time, and its path."""

    def __init__(self, rs: list):
        rs.sort(key=lambda r: (r[0], -r[1]))
        self.rs = rs
        self.starts = [r[0] for r in rs]
        self.parent = []
        stack: list = []
        for i, (a, _, _, _) in enumerate(rs):
            while stack and rs[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.bounds = sorted({x for a, b, _, p in rs if p for x in (a, b)})
        self._paths: dict = {}

    def innermost(self, t: float, program: bool) -> int:
        """The index of the innermost range open at ``t`` (a program range
        if ``program``), or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and (self.rs[i][1] <= t or (program and not self.rs[i][3])):
            i = self.parent[i]
        return i

    def path(self, i: int) -> tuple:
        """The program ranges from the outermost down to range ``i``."""
        if i not in self._paths:
            out, j = [], i
            while j >= 0:
                if self.rs[j][3]:
                    out.append(self.rs[j][2])
                j = self.parent[j]
            self._paths[i] = tuple(reversed(out))
        return self._paths[i]


def attribute(prof, names) -> dict:
    """``ranges``, ``idle_gaps`` (as ``analyse_trace`` gives them), ``busy_s``,
    ``window_s`` and ``kernels`` of the window in ``prof``, a finished
    ``torch.profiler.profile``; ``names`` are the program's span names."""
    from torch.autograd import DeviceType

    from portbench.harness import _merge
    names = set(names)
    by_tid: dict = collections.defaultdict(list)
    launches: dict = {}
    ops = []
    window = None
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((a, b, name, e.correlation_id()))
        elif e.device_type() != DeviceType.CPU:
            continue
        elif name == WINDOW:
            window, main = (a, b), e.start_thread_id()
        elif name in names:
            by_tid[e.start_thread_id()].append((a, b, name, True))
        elif name.startswith("portbench."):
            by_tid[e.start_thread_id()].append((a, b, name[10:], False))
        elif name.startswith(_LAUNCHES):
            launches[e.correlation_id()] = (a, e.start_thread_id())
    w0, w1 = window
    threads = {t: _Thread(rs) for t, rs in by_tid.items()}
    lead = threads.get(main) or _Thread([])

    def path(t: float, tid) -> str:
        p = lead.path(lead.innermost(t, True))
        if tid != main and tid in threads:
            th = threads[tid]
            p += th.path(th.innermost(t, True))
        return "/".join(p)

    ranges: dict = collections.defaultdict(
        lambda: {"n": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})
    for tid, th in threads.items():
        for i, (a, b, _, program) in enumerate(th.rs):
            if program and w0 <= a < w1:
                p = th.path(i)
                if tid != main:
                    p = lead.path(lead.innermost(a, True)) + p
                r = ranges["/".join(p)]
                r["n"] += 1
                r["host_s"] += (b - a) / 1e9

    kernels: dict = {}
    clipped = []
    for a, b, name, corr in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
        clipped.append((a, b))
        launch = launches.get(corr)
        ranges[path(*launch) if launch else "?"]["device_s"] += (b - a) / 1e9
    busy = _merge(clipped)

    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        lo = bisect.bisect_right(lead.bounds, a)
        hi = bisect.bisect_left(lead.bounds, b)
        cuts = [a] + lead.bounds[lo:hi] + [b]
        for x, y in zip(cuts, cuts[1:]):
            ranges[path((x + y) / 2, main)]["idle_s"] += (y - x) / 1e9
        i = lead.innermost((a + b) / 2, False)
        label = OUTSIDE if i < 0 else (
            "/".join(lead.path(i)) if lead.rs[i][3] else lead.rs[i][2])
        n, t = gaps.get(label, (0, 0.0))
        gaps[label] = (n + 1, t + (b - a) / 1e9)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": kernels,
        "ranges": dict(ranges),
        "idle_gaps": sorted(([f"{k} ({n} gaps)", t] for k, (n, t) in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _ms(ranges: dict, field: str, test, per) -> "float | None":
    """``field``'s seconds over the paths that pass ``test`` (on the path's
    names), over ``per``, in ms; None where no path passes."""
    hit = [v[field] for p, v in ranges.items() if test(p.split("/"))]
    return sum(hit) / per * 1e3 if hit and per else None


def readings(ranges: dict, records: dict) -> dict:
    """The per-layer numbers the ranges give, in ms; a number whose ranges
    the window lacks is left out.  Train: device ms a step under
    ``train.fwd_bwd``, ``train.quantize_ef``, ``train.clip`` with
    ``train.adamw``.  Serve: idle ms a ``serve.decode_step`` under it;
    device ms a ``serve.prefill`` under its ``model.attention``,
    ``model.mamba`` and ``model.moe`` ranges."""
    steps = records.get("steps") if records.get("kind") == "train" else None
    decodes = ranges.get("serve.decode_step", {}).get("n")
    prefills = ranges.get("serve.prefill", {}).get("n")

    def under(*phases):
        return lambda ps: ps[0] in phases

    def prefill(layer):
        return lambda ps: ps[0] == "serve.prefill" and layer in ps

    out = {
        "fwd_bwd_ms": _ms(ranges, "device_s", under("train.fwd_bwd"), steps),
        "quantize_ef_ms": _ms(ranges, "device_s", under("train.quantize_ef"), steps),
        "optimizer_ms": _ms(ranges, "device_s", under("train.clip", "train.adamw"),
                            steps),
        "decode_idle_ms": _ms(ranges, "idle_s", under("serve.decode_step"), decodes),
        "attention_ms": _ms(ranges, "device_s", prefill("model.attention"), prefills),
        "mamba_ms": _ms(ranges, "device_s", prefill("model.mamba"), prefills),
        "moe_ms": _ms(ranges, "device_s", prefill("model.moe"), prefills),
    }
    return {k: v for k, v in out.items() if v is not None}


def span_summary(spans: list) -> dict:
    """{span name: [count, host ms in all]} of the ring's events."""
    out: dict = {}
    for e in spans:
        if e.get("ph") == "X":
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = [n + 1, ms + e["dur"] / 1e3]
    return out


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        root: str = ROOT) -> dict:
    """One run of cell ``name`` without its check: what ``main`` prints."""
    import time

    from portbench import harness
    t_start = time.perf_counter()
    cell, wl, _ = harness.make_cell(name, seed, seconds, trace, device, root)
    out = harness.driver(wl["driver"], root).run(cell)
    win = out.window
    result = {"workload": name, "seed": seed, "trace": int(trace),
              "setup_s": win.t0 - t_start, "window_s": win.seconds,
              "attempted": int(out.attempted), "failed": int(out.failed), **out.e2e,
              "spans": span_summary(win.spans)}
    if cell.device.type == "cuda":
        import torch
        result["device"] = torch.cuda.get_device_name(cell.device)
        result["power_limit_w"] = harness.power_limit_w()
    if win.prof is not None:
        plain = harness.analyse_trace(win.prof)
        att = attribute(win.prof, {e["name"] for e in win.spans})
        win.prof = None
        result.update(busy_s=att["busy_s"], trace_window_s=att["window_s"],
                      ranges=att["ranges"], idle_gaps=att["idle_gaps"],
                      readings=readings(att["ranges"], out.records),
                      analyse_trace={k: plain[k] for k in ("busy_s", "idle_gaps")})
    out.release()
    return result


def main(argv=None) -> int:
    import argparse
    import json
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.workload, args.seed, args.seconds, bool(args.trace))),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

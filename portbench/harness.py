"""Finds a cell's files by name, runs its driver and builds the result line.

A driver (``drivers/<name>.py``) exposes ``run(cell) -> Outcome``: it makes
its inputs from ``cell.seed``, sets the program up, runs the timed window
inside ``with cell.window() as w`` until ``w.expired()``, and hands back the
end-to-end values, what the per-layer readers need, a ``release`` that
frees the program's state and a ``check`` that runs the plain reference
and returns the numbers compared (each has its limit in the workload
file).  The harness reads the peak memory before ``release`` and runs
``check`` after it, so the reference never sets the peak.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

WINDOW = "portbench.window"


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded), compared whole: ``repro_torch`` is not ``repro``."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    return os.path.join(root, "portbench")


def spec(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, root: str = ROOT) -> dict:
    return _load(os.path.join(bench_dir(root), "workloads", f"{name}.json"))


class Configuration(dict):
    """A configuration file's keys, and the benchmark root it was read from,
    where its architecture module is found."""

    def __init__(self, keys: dict, root: str):
        super().__init__(keys)
        self.root = root


def config(name: str, root: str = ROOT) -> Configuration:
    return Configuration(_load(os.path.join(bench_dir(root), "configs", f"{name}.json")),
                         root)


def _module(path: str, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def driver(name: str, root: str = ROOT):
    return _module(os.path.join(bench_dir(root), "drivers", f"{name}.py"),
                   f"portbench_driver_{name}")


def metric_reader(name: str, root: str = ROOT):
    return _module(os.path.join(bench_dir(root), "metrics", f"{name}.py"),
                   "portbench_metric_" + name.replace(".", "_"))


def architecture(conf: dict):
    """The plain-reference module that speaks for ``conf``'s architecture
    (the contract is in ``reference/__init__.py``): ``reference/<stem>.py``
    of the root the configuration was read from, ``stem`` its
    ``reference`` key, ``model`` without one.  A dict not read by
    ``config`` takes this checkout's root."""
    stem = conf.get("reference", "model")
    path = os.path.join(bench_dir(getattr(conf, "root", ROOT)), "reference", f"{stem}.py")
    if not (isinstance(stem, str) and stem.isidentifier() and os.path.isfile(path)):
        raise ValueError(f"{conf.get('name')}: no reference module {stem!r} ({path})")
    return _reference(path, stem)


@functools.lru_cache(maxsize=None)
def _reference(path: str, stem: str):
    return _module(path, f"portbench_reference_{stem}")


# published config.json keys -> the program's ModelConfig fields, for any
# architecture that has them
_PUBLISHED = {
    "hidden_size": "d_model", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "head_dim": "d_head",
    "intermediate_size": "d_ff", "vocab_size": "vocab",
    "num_hidden_layers": "n_layers", "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings", "rope_theta": "rope_theta",
    "num_experts": "n_experts", "num_experts_per_tok": "experts_per_token",
    "mamba_d_state": "ssm_state", "mamba_d_conv": "ssm_conv",
    "mamba_expand": "ssm_expand", "capacity_factor": "capacity_factor",
}


def model_config(conf: dict):
    """The program's ModelConfig for a configuration file: its arch with
    the file's overrides, checked against the file's published keys and
    dtype, then by its architecture module (``check_program``), so the
    program runs what the file states."""
    from repro_torch.configs import get_config
    arch = architecture(conf)
    cfg = dataclasses.replace(get_config(conf["arch"]), **conf.get("overrides", {}))
    for key, field in _PUBLISHED.items():
        if key in conf and getattr(cfg, field) != conf[key]:
            raise ValueError(f"{conf['name']}: {key}={conf[key]} but the program "
                             f"runs {field}={getattr(cfg, field)}")
    if conf.get("dtype", "bfloat16") != cfg.dtype:
        raise ValueError(f"{conf['name']}: dtype {conf.get('dtype')} but the "
                         f"program computes in {cfg.dtype}")
    arch.check_program(conf, cfg)
    return cfg


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The timed window: ``--seconds`` of work on the host clock, ended by
    a synchronise; under ``--trace 1`` inside ``torch.profiler`` (started
    before the clock, so its start-up is not timed).  Spans the program
    records (``repro_torch.obs``) during the window are kept in ``spans``."""

    def __init__(self, cell: "Cell"):
        self.cell = cell
        self.prof = None
        self.spans: list = []

    def __enter__(self):
        from repro_torch import obs
        if self.cell.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cell.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        _sync(self.cell.device)
        obs.trace.clear()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.cell.seconds
        return self

    def expired(self) -> bool:
        return time.perf_counter() >= self.deadline

    def __exit__(self, *exc):
        from repro_torch import obs
        _sync(self.cell.device)
        self.t1 = time.perf_counter()
        self.seconds = self.t1 - self.t0
        self.spans = obs.trace.events()
        if self.prof is not None:
            self._range.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False


@dataclasses.dataclass
class Cell:
    name: str
    conf: dict
    cfg: object
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object

    def window(self) -> Window:
        return Window(self)

    def range(self, label: str):
        """A profiler range around a call into the program (traced runs
        only): the idle gaps of the breakdown are named by these."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("portbench." + label)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back after its window."""
    attempted: int
    failed: int
    e2e: dict                  # end-to-end metric -> value
    records: dict              # what the per-layer readers read
    window: Window
    release: Callable[[], None]
    check: Callable[[], dict]  # number compared -> reading
    # the same numbers with the reference's float8 control in the
    # program's place (calibration only; the benchmark's runs never call it)
    control: Optional[Callable[[], dict]] = None


@dataclasses.dataclass
class Observed:
    """What a per-layer reader gets: the driver's records, the window, the
    program's spans in it, and under ``--trace 1`` the device's kernels."""
    records: dict
    window_s: float
    spans: list
    kernels: dict              # kernel name -> device seconds in the window
    busy_s: Optional[float]
    trace_window_s: Optional[float]


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def analyse_trace(prof) -> dict:
    """Busy time, kernels and idle gaps of the traced window, from the
    profiler's raw events (building its event tree takes minutes on a
    30-second window): device operations are clipped to the window's
    range; an idle gap is named by the harness range (``cell.range``)
    that covers its midpoint on the host."""
    from torch.autograd import DeviceType
    ops, ranges, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, where = e.name(), e.device_type()
        a = e.start_ns()
        b = a + e.duration_ns()
        if name.startswith("portbench."):
            if where == DeviceType.CPU:
                if name == WINDOW:
                    window = (a, b)
                else:
                    ranges.append((a, b, name[10:]))
        elif where == DeviceType.CUDA:
            ops.append((a, b, name))
    w0, w1 = window
    kernels: dict = {}
    clipped = []
    for a, b, n in ops:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernels[n] = kernels.get(n, 0.0) + (b - a) / 1e9
            clipped.append((a, b))
    busy = _merge(clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    ranges.sort()
    starts = [r[0] for r in ranges]
    gaps: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        inner = [r for r in ranges[max(0, i - 64):i] if r[1] >= mid]
        label = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "host, outside the calls"
        n, t = gaps.get(label, (0, 0.0))
        gaps[label] = (n + 1, t + (b - a) / 1e9)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": kernels,
        "device_ops": sorted(([k[:120], v] for k, v in kernels.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([f"{k} ({n} gaps)", t] for k, (n, t) in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def power_limit_w() -> Optional[float]:
    """The card's power limit (``nvidia-smi``), kept beside every rate."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def make_cell(name: str, seed: int, seconds: float, trace: bool,
              device: str = "cuda", root: str = ROOT) -> tuple:
    """(cell, its workload file, BENCHMARK.json) for cell ``name``."""
    import torch
    wl = workload(name, root)
    conf = config(wl["config"], root)
    cell = Cell(name=name, conf=conf, cfg=model_config(conf), traffic=wl["traffic"],
                seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=torch.device(device))
    return cell, wl, spec(root)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT,
             t_start: Optional[float] = None) -> dict:
    """One run of cell ``name``: the result line's object."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cell, wl, bench = make_cell(name, seed, seconds, trace, device, root)
    out: Outcome = driver(wl["driver"], root).run(cell)
    win = out.window
    setup_s = win.t0 - t_start
    dev = cell.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = analyse_trace(win.prof) if win.prof is not None else None
    win.prof = None
    out.release()
    readings = out.check()

    limits = wl["limits"]
    checks = {k: {"value": readings.get(k, math.nan), "limit": v}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    values = dict(out.e2e, setup_s=setup_s)
    metrics = {}
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        seen = Observed(records=out.records, window_s=win.seconds, spans=win.spans,
                        kernels=traced["kernels"], busy_s=traced["busy_s"],
                        trace_window_s=traced["window_s"])
        for m in bench["per_layer"]:
            if _applies(m, name, e2e_names):
                v = metric_reader(m["name"], root).read(seen)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": wl.get("chips", 1), "memory_peak_bytes": peak}
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    return result

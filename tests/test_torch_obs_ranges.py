"""The port's spans as ``torch.profiler`` ranges (``repro_torch.obs.trace``):
a range of each span's name, nested as the spans nest, on the thread that
opened it, only while a profiler records and observability is on; none and
no torch import elsewhere.  And the spans the train step, the token
pipeline, the model's layers and the serve engine open."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.obs import trace

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _ranges(prof, names) -> list:
    """(name, start, end, thread, user annotation) of the trace's events
    named in ``names``, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns(), e.start_thread_id(),
                        e.is_user_annotation()))
    return sorted(out, key=lambda r: r[1])


@pytest.fixture
def ring():
    prev = obs.metrics.set_enabled(True)
    trace.clear()
    yield
    trace.clear()
    obs.metrics.set_enabled(prev)


def test_a_span_opens_a_profiler_range_of_its_name_nested_as_spans_nest(ring):
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.outer"):
            with trace.span("test.inner"):
                y = x @ x
            with trace.span("test.inner"):
                y = y @ x
    got = _ranges(prof, {"test.outer", "test.inner", "aten::mm"})
    assert [g[0] for g in got] == ["test.outer", "test.inner", "aten::mm",
                                   "test.inner", "aten::mm"]
    outer = got[0]
    assert all(outer[1] <= g[1] and g[2] <= outer[2] for g in got[1:])
    assert got[1][1] <= got[2][1] and got[2][2] <= got[1][2]      # mm inside
    assert got[1][2] <= got[3][1]                                  # siblings apart
    assert len({g[3] for g in got}) == 1
    assert not any(g[4] for g in got if g[0].startswith("test."))   # operations
    assert [e["name"] for e in trace.events()] == ["test.inner", "test.inner",
                                                  "test.outer"]


def test_no_range_without_a_profiler_or_with_observability_off(ring):
    assert trace._profiler_range("test.none") is None
    with trace.span("test.plain") as s:
        assert s._range is None
    obs.metrics.set_enabled(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.off"):
            torch.ones(4).sum()
    assert _ranges(prof, {"test.off"}) == []
    assert [e["name"] for e in trace.events()] == ["test.plain"]


def test_a_range_left_open_when_the_profiler_stops_closes_quietly(ring):
    with trace.span("test.straddle"):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("test.within"):
                pass
            s = trace.span("test.open")
            s.__enter__()
        s.__exit__(None, None, None)
    assert [e["name"] for e in trace.events()] == ["test.within", "test.open",
                                                  "test.straddle"]


def test_a_forked_childs_spans_carry_its_own_pid():
    """The pid is read once; a forked child reads its own (in a process
    of one thread, without torch)."""
    code = ("import json, os\n"
            "from repro_torch.obs import trace\n"
            "with trace.span('test.parent'):\n"
            "    pass\n"
            "r, w = os.pipe()\n"
            "pid = os.fork()\n"
            "if pid == 0:\n"
            "    trace.clear()\n"
            "    with trace.span('test.child'):\n"
            "        pass\n"
            "    os.write(w, json.dumps(trace.events()).encode())\n"
            "    os._exit(0)\n"
            "os.close(w)\n"
            "child = json.loads(os.fdopen(r).read())\n"
            "os.waitpid(pid, 0)\n"
            "assert [e['pid'] for e in trace.events()] == [os.getpid()]\n"
            "assert [(e['name'], e['pid']) for e in child] == [('test.child', pid)]\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}, timeout=120)
    assert r.returncode == 0, r.stderr


def test_spans_import_no_torch():
    code = ("import sys\n"
            "from repro_torch.obs import trace\n"
            "with trace.span('test.alone'):\n"
            "    pass\n"
            "assert [e['name'] for e in trace.events()] == ['test.alone']\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}, timeout=120)
    assert r.returncode == 0, r.stderr


def _names(prof) -> dict:
    """{range name: count} of the trace's program ranges."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if n.split(".")[0] in ("train", "model", "serve", "pipeline"):
            out[n] = out.get(n, 0) + 1
    return out


def test_the_train_step_spans_its_phases_and_the_models_layers(ring):
    from repro_torch import train as T
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")), remat="full")
    model = Model(cfg)
    state = T.init_train_state(model, torch.Generator().manual_seed(0),
                               compress_grads=True)
    step = T.make_train_step(model, compress_grads=True)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(2, cfg.vocab, (2, 16), generator=g)
             for k in ("tokens", "targets")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    per_group = {"model.attention": 1, "model.mamba": 7, "model.moe": 4}
    # each group runs twice: the forward and its recompute in the backward
    layers = {k: 2 * v * cfg.n_groups for k, v in per_group.items()}
    phases = {"train.fwd_bwd": 1, "train.quantize_ef": 1, "train.clip": 1,
              "train.adamw": 1}
    assert _names(prof) == dict(phases, **layers)
    spans: dict = {}
    for e in trace.events():
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    assert spans == dict(phases, **layers)
    rs = _ranges(prof, set(phases))
    assert [r[0] for r in rs] == list(phases)               # in the step's order
    assert all(a[2] <= b[1] for a, b in zip(rs, rs[1:]))


def test_the_pipeline_spans_the_consumers_wait_and_keeps_no_queue_gauge(ring, tmp_path):
    from repro_torch.data import TokenPipeline, write_token_shards
    paths = [str(tmp_path / f"s{i}.bskt") for i in range(2)]
    write_token_shards(paths, vocab=512, tokens_per_shard=4096, seed=3)
    pipe = TokenPipeline(paths, batch=4, seq_len=16, seed=3)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                next(pipe)
    finally:
        pipe.close()
    assert _names(prof).get("pipeline.next") == 3
    assert sum(e["name"] == "pipeline.next" for e in trace.events()) == 3
    snap = obs.metrics.REGISTRY.snapshot()
    kept = [k for kind in snap.values() for k in kind]
    assert not [k for k in kept if k.startswith(("pipeline.batches",
                                                 "pipeline.queue_depth"))], kept
    assert [k for k in kept if k.startswith("pipeline.shards")]


def test_the_serve_engine_spans_prefill_decode_and_the_layers_and_counts_nothing(ring):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    cfg = reduced(get_config("jamba-v0.1-52b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    engine = ServeEngine(model, params, batch_slots=2, max_len=24)
    rng = np.random.default_rng(0)
    for n in (5, 8):
        engine.submit(rng.integers(2, cfg.vocab, n), 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = engine.run()
    assert sorted(len(v) for v in out.values()) == [3, 3]
    got = _names(prof)
    layers = {"model.attention": 1, "model.mamba": 7, "model.moe": 4}
    steps = got["serve.prefill"] + got["serve.decode_step"]
    assert got["serve.prefill"] == 1 and got["serve.decode_step"] == 2
    assert {k: got[k] for k in layers} == {k: v * cfg.n_groups * steps
                                          for k, v in layers.items()}
    snap = obs.metrics.REGISTRY.snapshot()
    assert not [k for kind in snap.values() for k in kind if k.startswith("serve.")]

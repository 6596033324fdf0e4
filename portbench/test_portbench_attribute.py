"""``attribute.py`` against synthetic kineto-like traces, the new reader
against a synthetic ``Observed``, and traced CPU runs of the small cells
that hold the program's ranges.  A trace with no program range gives
``harness.analyse_trace``'s outputs, pinned as a golden."""

import dataclasses
import json
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from portbench import attribute, harness
from portbench.test_portbench_runs import SEED, SERVE, HYBRID, TRAIN, _root

MAIN, AUTOGRAD = 1, 2


@dataclasses.dataclass
class Ev:
    """A kineto event as ``prof.profiler.kineto_results.events()`` gives it."""
    n: str
    a: int
    b: int
    tid: int = MAIN
    corr: int = 0
    cuda: bool = False
    annotation: bool = False

    def name(self):
        return self.n

    def device_type(self):
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def is_user_annotation(self):
        return self.annotation

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.corr


class Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda _: list(evs)})()


def kernel(corr, a, b, t_launch, tid=MAIN, name="k"):
    """A device operation and the runtime call that launched it."""
    return [Ev("cudaLaunchKernel", t_launch, t_launch + 5, tid, corr),
            Ev(name, a, b, 0, corr, cuda=True)]


def harness_only_trace() -> list:
    """The harness's ranges and kernels only: a program without profiler
    ranges."""
    evs = [Ev(harness.WINDOW, 0, 10_000),
           Ev(harness.WINDOW, 100, 9_900, 0, cuda=True, annotation=True),
           Ev("portbench.serve.wave", 1_000, 8_000),
           Ev("portbench.serve.wave", 1_000, 7_000, 0, cuda=True, annotation=True),
           Ev("aten::mm", 1_100, 1_150)]
    evs += kernel(1, 1_200, 2_000, 1_110, name="gemm_a")
    evs += kernel(2, 2_000, 2_500, 1_300, name="elementwise_b")
    evs += kernel(3, 4_000, 4_100, 3_900, name="gemm_a")
    evs += kernel(4, 9_000, 9_500, 8_500, name="copy_c")
    evs += kernel(5, 10_500, 11_000, 9_990, name="after_the_window")
    return evs


GOLDEN = {
    "busy_s": 1.9e-06,
    "window_s": 1e-05,
    "kernels": {"gemm_a": 9e-07, "elementwise_b": 5e-07, "copy_c": 5e-07},
    "device_ops": [["gemm_a", 9e-07], ["elementwise_b", 5e-07], ["copy_c", 5e-07]],
    "idle_gaps": [["serve.wave (2 gaps)", 6.4e-06],
                  ["host, outside the calls (2 gaps)", 1.7e-06]],
}


def _close(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return abs(a - b) <= 1e-15
    return a == b


def test_a_trace_without_program_ranges_gives_the_harness_outputs_pinned():
    prof = Prof(harness_only_trace())
    got = harness.analyse_trace(prof)
    assert _close(got, GOLDEN), got
    att = attribute.attribute(prof, set())
    for k in ("busy_s", "window_s", "kernels", "idle_gaps"):
        assert _close(att[k], got[k]), k
    assert _close(att["ranges"], {"": {"n": 0, "host_s": 0.0, "device_s": 1.9e-06,
                                       "idle_s": 8.1e-06}})


def test_annotation_events_are_not_device_work():
    evs = harness_only_trace() + [
        Ev("serve.prefill", 2_600, 3_800),
        Ev("serve.prefill", 2_700, 3_700, 0, cuda=True, annotation=True)]
    att = attribute.attribute(Prof(evs), {"serve.prefill"})
    assert _close(att["busy_s"], GOLDEN["busy_s"])
    assert _close(att["kernels"], GOLDEN["kernels"])
    assert att["ranges"]["serve.prefill"]["device_s"] == 0.0


def test_a_launch_from_another_thread_goes_under_the_driving_threads_range():
    evs = [Ev(harness.WINDOW, 0, 10_000),
           Ev("portbench.train.step", 500, 9_500),
           Ev("train.fwd_bwd", 1_000, 6_000),
           Ev("model.attention", 1_100, 1_500),
           Ev("model.attention", 3_000, 3_400, AUTOGRAD),       # the recompute
           Ev("train.adamw", 7_000, 8_000)]
    evs += kernel(1, 1_200, 1_400, 1_150)                       # forward
    evs += kernel(2, 2_000, 2_900, 1_900, AUTOGRAD)             # backward
    evs += kernel(3, 3_100, 3_500, 3_050, AUTOGRAD)             # recompute
    evs += kernel(4, 7_200, 7_900, 7_100)
    att = attribute.attribute(Prof(evs), {"train.fwd_bwd", "model.attention",
                                          "train.adamw"})
    r = att["ranges"]
    assert _close(r["train.fwd_bwd/model.attention"],
                  {"n": 2, "host_s": 8e-07, "device_s": 6e-07, "idle_s": 2e-07})
    assert _close(r["train.fwd_bwd"]["device_s"], 9e-07)
    assert r["train.fwd_bwd"]["n"] == 1 and r["train.adamw"]["n"] == 1
    assert _close(r["train.adamw"]["device_s"], 7e-07)
    got = attribute.readings(r, {"kind": "train", "steps": 1})
    assert got == pytest.approx({"fwd_bwd_ms": 1.5e-3, "optimizer_ms": 7e-4})
    assert "?" not in r


def test_idle_pieces_go_to_the_innermost_range_and_gaps_by_their_midpoint():
    evs = [Ev(harness.WINDOW, 0, 1_000),
           Ev("portbench.serve.wave", 50, 950),
           Ev("serve.decode_step", 100, 900),
           Ev("model.attention", 200, 400)]
    evs += kernel(1, 150, 160, 120)
    evs += kernel(2, 800, 850, 210)
    evs.append(Ev("lost", 600, 610, 0, 99, cuda=True))          # no launch event
    att = attribute.attribute(Prof(evs), {"serve.decode_step", "model.attention"})
    r = att["ranges"]
    ns = 1e-9
    assert _close(r[""]["idle_s"], 200 * ns)                   # 0-100, 900-1000
    assert _close(r["serve.decode_step"]["idle_s"],
                  (50 + 40 + 200 + 190 + 50) * ns)            # 100-150 ... 850-900
    assert _close(r["serve.decode_step/model.attention"]["idle_s"], 200 * ns)
    assert _close(r["serve.decode_step/model.attention"]["device_s"], 50 * ns)
    assert _close(r["serve.decode_step"]["device_s"], 10 * ns)
    assert _close(r["?"]["device_s"], 10 * ns)
    assert sum(v["idle_s"] for v in r.values()) + att["busy_s"] == pytest.approx(1e-6)
    assert _close(att["idle_gaps"], [["serve.decode_step/model.attention (1 gaps)",
                                      440 * ns],
                                     ["serve.wave (2 gaps)", 300 * ns],
                                     ["serve.decode_step (1 gaps)", 190 * ns]])
    got = attribute.readings(r, {"kind": "serve"})
    assert got == pytest.approx({"decode_idle_ms": 730 * ns * 1e3})


def test_readings_per_prefill_under_each_layer():
    z = {"n": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0}
    ranges = {"serve.prefill": dict(z, n=2, device_s=0.5),
              "serve.prefill/model.attention": dict(z, n=2, device_s=0.2),
              "serve.prefill/model.mamba": dict(z, n=14, device_s=0.6),
              "serve.prefill/model.moe": dict(z, n=8, device_s=0.1),
              "serve.decode_step": dict(z, n=4, idle_s=0.4),
              "serve.decode_step/model.mamba": dict(z, n=28, device_s=1.0, idle_s=0.2)}
    got = attribute.readings(ranges, {"kind": "serve"})
    assert got == pytest.approx({"decode_idle_ms": 150.0, "attention_ms": 100.0,
                                 "mamba_ms": 300.0, "moe_ms": 50.0})
    assert attribute.readings({}, {"kind": "train", "steps": 3}) == {}


def test_the_pipeline_queue_reader():
    read = harness.metric_reader("pipeline_queue_ms").read
    seen = harness.Observed(
        records={"kind": "train", "steps": 4}, window_s=1.0,
        spans=[{"name": "pipeline.next", "ph": "X", "dur": 250.0}] * 4
        + [{"name": "train.fwd_bwd", "ph": "X", "dur": 9e5}],
        kernels={}, busy_s=None, trace_window_s=None)
    assert read(seen) == pytest.approx(0.25)
    assert read(dataclasses.replace(seen, spans=seen.spans[-1:])) is None
    assert read(dataclasses.replace(seen, records={"kind": "serve"})) is None


@pytest.fixture(scope="module")
def small_root(tmp_path_factory) -> Path:
    return _root(tmp_path_factory.mktemp("small"), {})


@pytest.mark.parametrize("cell,paths", [
    (TRAIN, ["train.fwd_bwd", "train.fwd_bwd/model.attention", "train.quantize_ef",
             "train.clip", "train.adamw", "pipeline.next"]),
    (SERVE, ["serve.prefill", "serve.prefill/model.attention", "serve.decode_step",
             "serve.decode_step/model.attention"]),
    (HYBRID, ["serve.prefill/model.attention", "serve.prefill/model.mamba",
              "serve.prefill/model.moe", "serve.decode_step/model.mamba",
              "serve.decode_step/model.moe"])])
def test_a_traced_cpu_run_holds_the_programs_ranges(small_root, cell, paths):
    r = attribute.run(cell, SEED, 1.0, True, device="cpu", root=str(small_root))
    json.dumps(r)
    assert r["failed"] == 0 and r["attempted"] > 0
    for p in paths:
        assert r["ranges"][p]["n"] >= 1, (p, sorted(r["ranges"]))
        assert r["spans"][p.split("/")[-1]][0] >= 1
    assert r["busy_s"] == r["analyse_trace"]["busy_s"] == 0.0      # no device here
    idle = sum(v["idle_s"] for v in r["ranges"].values())
    assert idle == pytest.approx(r["trace_window_s"])
    want = {TRAIN: {"fwd_bwd_ms", "quantize_ef_ms", "optimizer_ms"},
            SERVE: {"decode_idle_ms", "attention_ms"},
            HYBRID: {"decode_idle_ms", "attention_ms", "mamba_ms", "moe_ms"}}[cell]
    assert set(r["readings"]) == want


def test_the_traced_train_cell_reports_the_pipelines_own_wait(small_root):
    r = harness.run_cell(TRAIN, SEED, 1.0, True, device="cpu", root=str(small_root))
    q = r["metrics"]["pipeline_queue_ms"]["value"]
    assert 0 < q <= r["metrics"]["pipeline_wait_ms"]["value"]

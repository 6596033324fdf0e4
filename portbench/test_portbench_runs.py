"""Whole runs of the harness on the CPU at a small size: every cell's
driver, its check and its readers, with the look for a chip skipped.  A
sound run comes out correct under each cell's own limits; each fault the
cell can have, and the float8 control, come out not correct; a cell, a
metric and an architecture added as new files run."""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import faults, harness
from portbench.drivers import serve_waves, train as train_driver
from portbench.weights import seeded_params

ROOT = Path(harness.ROOT)
SEED = 2 ** 31 + 11
TRAIN = "qwen3-8b.train-8x512"
SERVE = "qwen3-8b.prefill-2k"
HYBRID = "jamba-v0.1-52b.prefill-512"


def _small_config(name: str, d: int = 64, vocab: int = 512, layers: int = 2) -> dict:
    conf = harness.config(name, str(ROOT))
    heads = 8 if d > 64 else 4
    conf.update(hidden_size=d, num_attention_heads=heads, num_key_value_heads=2,
                head_dim=16, intermediate_size=2 * d, vocab_size=vocab)
    over = dict(conf["overrides"], d_model=d, n_heads=heads, n_kv_heads=2, d_head=16,
                d_ff=2 * d, vocab=vocab)
    if conf["model_type"] == "jamba":
        conf.update(num_experts=4, mamba_d_state=8, mamba_dt_rank=d // 16)
        over.update(d_ff_expert=2 * d, n_experts=4, ssm_state=8)
    else:
        conf["num_hidden_layers"] = over["n_layers"] = min(conf["num_hidden_layers"], layers)
    conf["overrides"] = over
    return conf


def _small_traffic(wl: dict) -> dict:
    if wl["driver"] == "train":
        return dict(wl["traffic"], batch=4, seq_len=32, n_shards=2)
    # every finished request checked, so a fault in one slot always shows
    return dict(wl["traffic"], slots=4, cycle=2, max_len=40, prompt_len=[16, 32],
                check_requests=1000)


def _root(base: Path, sizes: dict) -> Path:
    """The benchmark's files with each configuration and traffic cut to a
    CPU size (``sizes``: configuration -> ``_small_config``'s keywords);
    names, drivers, readers and limits as they are."""
    shutil.copytree(ROOT / "portbench", base / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "test_*"))
    shutil.copy(ROOT / "BENCHMARK.json", base)
    for c in harness.spec(str(ROOT))["configs"]:
        (base / "portbench/configs" / f"{c['name']}.json").write_text(
            json.dumps(_small_config(c["name"], **sizes.get(c["name"], {}))))
    for w in harness.spec(str(ROOT))["workloads"]:
        wl = harness.workload(w["name"], str(ROOT))
        wl["traffic"] = _small_traffic(wl)
        (base / "portbench/workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    return base


@pytest.fixture(scope="module")
def small_root(tmp_path_factory) -> Path:
    return _root(tmp_path_factory.mktemp("small"), {})


@pytest.fixture(scope="module")
def control_root(tmp_path_factory) -> Path:
    """A serving size at which the float8 control's widest gap reaches what
    it is at the cell's own: a tiny model's stays under the limit.  (The
    hybrid's median gap does not at any CPU size tried, d_model 128 to 512:
    its control test runs on the card.)"""
    return _root(tmp_path_factory.mktemp("control"),
                 {"qwen3-8b": {"d": 512, "vocab": 16384, "layers": 4}})


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(root, cell, trace=False, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu", root=str(root))


@pytest.mark.parametrize("cell", [TRAIN, SERVE, HYBRID])
def test_a_sound_run_is_correct_under_the_cells_limits(small_root, cell):
    r = _run(small_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    e2e = [m["name"] for m in harness.spec(str(small_root))["end_to_end"]
           if cell in m.get("workloads", [cell])]
    assert sorted(r["metrics"]) == sorted(e2e)
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("cell,fault", [(TRAIN, "unchanged"), (TRAIN, "half_batch"),
                                        (SERVE, "token"), (SERVE, "tokens"),
                                        (HYBRID, "tokens")])
def test_each_fault_of_the_timed_path_comes_out_not_correct(small_root, cell, fault):
    with faults.planted(fault):
        r = _run(small_root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_the_float8_control_fails_a_limit_of_the_cell(small_root, control_root, cell):
    root = str(small_root if cell == TRAIN else control_root)
    c, wl, _ = harness.make_cell(cell, SEED, 0.5, False, "cpu", root)
    out = harness.driver(wl["driver"], root).run(c)
    out.release()
    control = out.control()
    assert any(control[k] > v for k, v in wl["limits"].items()), (control, wl["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [TRAIN, SERVE, HYBRID])
def test_at_the_cells_own_size_the_program_passes_and_the_control_fails(card, cell):
    c, wl, _ = harness.make_cell(cell, SEED, 6.0, False, "cuda")
    out = harness.driver(wl["driver"]).run(c)
    out.release()
    program, control = out.check(), out.control()
    assert all(program[k] <= v for k, v in wl["limits"].items()), (program, wl["limits"])
    assert any(control[k] > v for k, v in wl["limits"].items()), (control, wl["limits"])


def test_a_cell_and_a_metric_added_as_new_files_run(small_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(small_root, root)
    wl = harness.workload(SERVE, str(root))
    wl["traffic"] = dict(wl["traffic"], new_tokens=[3, 3])
    (root / "portbench/workloads/dummy.waves.json").write_text(json.dumps(wl))
    (root / "portbench/metrics/dummy_requests.py").write_text(
        "def read(seen):\n    return float(seen.records['requests'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy.waves", "config": wl["config"],
                              "traffic": "waves", "chips": 1, "why": "a new cell"})
    for m in spec["end_to_end"]:
        if SERVE in m.get("workloads", []):
            m["workloads"].append("dummy.waves")
    spec["per_layer"].append({"name": "dummy_requests", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "serve engine",
                              "moves": "serve_tok_s", "workloads": ["dummy.waves"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell("dummy.waves", SEED, 1.0, True, device="cpu", root=str(root))
    assert r["correct"] and r["metrics"]["dummy_requests"]["value"] >= 4
    assert set(r["metrics"]) == {"dummy_requests"}     # the others name their cells
    assert r["breakdown"]["idle_gaps"]


# A probe architecture: qwen3's layers under a model_type of its own, with
# its own module, layer check and FLOP count (which keeps the prompt
# lengths it was asked for); its logits of token 0 moved by SHIFT.
PROBE = """
from portbench.reference import model

SHIFT = {shift}
PREFILLS = []


def _qwen3(conf):
    return dict(conf, model_type="qwen3")


def layer_kinds(conf):
    return [("attn", "dense")] * conf["num_hidden_layers"]


def period(conf):
    return 1


def check_program(conf, cfg):
    model.check_program(_qwen3(conf), cfg)


def prefill_flops(conf, prompt_len):
    PREFILLS.append(prompt_len)
    return model.prefill_flops(_qwen3(conf), prompt_len)


def train_flops_per_token(conf, seq_len):
    return model.train_flops_per_token(_qwen3(conf), seq_len)


class Reference(model.Reference):
    def __init__(self, conf, params, fp8=False):
        super().__init__(_qwen3(conf), params, fp8)

    def logits(self, h):
        out = super().logits(h)
        out[..., 0] += SHIFT
        return out
"""


def _hashes(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add_probe(root: Path, shift: float) -> None:
    """The probe as new files of ``root``: its module, a configuration that
    names it, a serving cell on it, and their entries in BENCHMARK.json."""
    (root / "portbench/reference/probe.py").write_text(PROBE.format(shift=shift))
    conf = harness.config("qwen3-8b", str(root))
    conf.update(name="probe", model_type="probe", reference="probe")
    (root / "portbench/configs/probe.json").write_text(json.dumps(conf))
    wl = dict(harness.workload(SERVE, str(root)), config="probe")
    (root / "portbench/workloads/probe.waves.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "probe", "source": conf["source"],
                            "file": "portbench/configs/probe.json", "reduced": [],
                            "why": "a probe architecture"})
    spec["workloads"].append({"name": "probe.waves", "config": "probe", "traffic": "waves",
                              "chips": 1, "why": "a cell on the probe"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if SERVE in m.get("workloads", []):
            m["workloads"].append("probe.waves")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("shift", [0.0, 100.0])
def test_an_architecture_added_as_new_files_runs_on_its_own_reference(small_root, tmp_path,
                                                                       shift):
    root = tmp_path / "root"
    shutil.copytree(small_root, root)
    before = _hashes(root)
    old_spec = harness.spec(str(root))
    _add_probe(root, shift)
    r = harness.run_cell("probe.waves", SEED, 1.0, shift == 0, device="cpu", root=str(root))
    probe = harness.architecture(harness.config("probe", str(root)))
    assert probe.__file__ == str(root / "portbench/reference/probe.py")
    assert probe.PREFILLS                       # the driver counted with the probe's FLOPs
    assert r["correct"] == (shift == 0), r["checks"]
    if shift == 0:
        assert r["metrics"]["prefill_mfu"]["value"] > 0
    after = _hashes(root)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    spec = harness.spec(str(root))
    for key in ("configs", "workloads"):
        assert spec[key][:-1] == old_spec[key]


def test_a_configuration_naming_a_missing_reference_module_is_refused(small_root, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(small_root, root)
    path = root / "portbench/configs/qwen3-8b.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), reference="deepseek_v2")))
    with pytest.raises(ValueError, match="deepseek_v2"):
        harness.make_cell(SERVE, SEED, 1.0, False, "cpu", str(root))


def test_a_request_that_stops_on_its_end_token_has_not_failed(small_root, monkeypatch):
    """Every slot ends at its first decode step (the end token 1), short of
    its count: the answers are numpy arrays, and ``failed`` stays an int
    the result line can carry."""
    import repro_torch.serve.engine as engine
    monkeypatch.setattr(engine, "sample_logits",
                        lambda logits, generator=None, temperature=0.0:
                        torch.ones(logits.shape[0], dtype=torch.int32))
    r = _run(small_root, SERVE)
    assert r["failed"] == 0 and type(r["failed"]) is int
    assert json.loads(json.dumps(r))["attempted"] == r["attempted"] > 0
    assert serve_waves._failed(2, [(None, np.array([7, 1], np.int32), 0, 0.0, 4),
                                   (None, np.array([7], np.int32), 0, 0.0, 4)]) == 1


def test_the_yardstick_orders_batches_as_the_pipeline_serves_them(tmp_path):
    from repro_torch.core.bfile import BasketWriter
    from repro_torch.core.policy import choose
    from repro_torch.data import TokenPipeline
    B, S = 4, 16
    toks = train_driver.shard_tokens(SEED, 512, 2, (S + 1) * B * 32)
    paths = [str(tmp_path / f"s{i}.bskt") for i in range(2)]
    for p, t in zip(paths, toks):
        with BasketWriter(p) as w:
            w.write_branch("tokens", t, choose("tokens", t, "analysis"))
    pipe = TokenPipeline(paths, batch=B, seq_len=S, seed=SEED)
    try:
        got = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    for g, (x, y) in zip(got, train_driver.expected_batches(toks[0], B, S, SEED, 3)):
        assert np.array_equal(g["tokens"], x) and np.array_equal(g["targets"], y)
    rows = np.concatenate([g["tokens"] for g in got])
    assert len({r.tobytes() for r in rows}) == len(rows)


def test_waves_offer_every_seed_the_same_work_in_another_order():
    traffic = {"slots": 8, "cycle": 2, "prompt_len": [1024, 2048], "new_tokens": [2, 8]}
    shapes = serve_waves.cycle_shapes(traffic)
    sizes = sorted(sorted(L for L, _ in w) for w in shapes)
    a = serve_waves.waves(SEED, traffic, 151936)
    b = serve_waves.waves(SEED + 1, traffic, 151936)
    again = serve_waves.waves(SEED, traffic, 151936)
    for _ in range(3):                    # three cycles of two waves
        ca = [next(a) for _ in range(2)]
        cb = [next(b) for _ in range(2)]
        c2 = [next(again) for _ in range(2)]
        for wa, w2 in zip(ca, c2):
            assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(wa, w2))
        for c in (ca, cb):
            assert sorted(sorted(len(p) for p, _ in w) for w in c) == sizes
            assert all(sorted(k for _, k in w) == [2, 3, 4, 5, 5, 6, 7, 8] for w in c)
            assert all(p.min() >= 2 and p.max() < 151936 for w in c for p, _ in w)
    lens = sorted(L for w in shapes for L, _ in w)
    assert lens[0] > 1024 and lens[-1] <= 2048 and sum(lens) / len(lens) == 1536
    assert [max(L for L, _ in w) for w in shapes] == [1952, 2016]


def test_weights_come_from_the_seed_alone():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    model = Model(reduced(get_config("jamba-v0.1-52b")))
    a = seeded_params(model, SEED, torch.bfloat16, torch.device("cpu"))
    b = seeded_params(model, SEED, torch.bfloat16, torch.device("cpu"))
    c = seeded_params(model, SEED + 1, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
    ones = a["layers"]["l0"]["ln1"]["scale"]
    assert ones.dtype == torch.bfloat16 and bool((ones == 1).all())
    std = a["layers"]["l0"]["mamba"]["in_proj"].float().std()
    assert abs(float(std) - 64 ** -0.5) < 0.1 * 64 ** -0.5

"""The deepseek-v2-lite cell end to end on the CPU at a small size, in a
root of its own: the benchmark's files with the configuration cut to
d_model 64 and three layers (the dense first layer, then two MoE layers of
12 experts top-6 with the shared experts), latent attention and YaRN kept,
and the traffic cut to 4 slots of 16-32 tokens.  A sound run is correct
under the cell's own limits and its traced run reads the new per-layer
metric; a fault of the timed path is not correct; the layer check refuses
a program that renormalises its gates or has another latent width.  On the
card, at the cell's own size, the program passes and the float8 control
fails."""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import faults, harness

ROOT = Path(harness.ROOT)
SEED = 2 ** 31 + 23
CELL = "deepseek-v2-lite.prefill-4k"
CONF = "deepseek-v2-lite"
LAYERS = 3

SMALL = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
         "intermediate_size": 128, "vocab_size": 512, "num_hidden_layers": LAYERS,
         "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
         "v_head_dim": 16, "n_routed_experts": 12, "moe_intermediate_size": 48}
OVERRIDES = {"d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 128,
             "vocab": 512, "n_layers": LAYERS, "kv_lora_rank": 32, "qk_nope_dim": 16,
             "qk_rope_dim": 8, "n_experts": 12, "d_ff_expert": 48, "d_ff_shared": 96}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory) -> Path:
    base = tmp_path_factory.mktemp("deepseek")
    shutil.copytree(ROOT / "portbench", base / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "test_*"))
    shutil.copy(ROOT / "BENCHMARK.json", base)
    conf = harness.config(CONF, str(ROOT))
    conf.update(SMALL, overrides=OVERRIDES)
    (base / "portbench/configs" / f"{CONF}.json").write_text(json.dumps(conf))
    wl = harness.workload(CELL, str(ROOT))
    wl["traffic"] = dict(wl["traffic"], slots=4, max_len=40, prompt_len=[16, 32],
                         check_requests=1000)
    (base / "portbench/workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    return base


@pytest.fixture(autouse=True)
def short_stack(monkeypatch):
    """The program's arch with its pattern cut as the small root's layers:
    the dense first layer, then MoE layers (a 27-entry pattern cannot be
    cut from a configuration file's overrides)."""
    import repro_torch.configs as configs
    real = configs.get_config

    def get_config(name):
        cfg = real(name)
        return dataclasses.replace(cfg, pattern=cfg.pattern[:LAYERS]) if name == CONF else cfg

    monkeypatch.setattr(configs, "get_config", get_config)


def _run(root, trace=False):
    return harness.run_cell(CELL, SEED, 1.0, trace, device="cpu", root=str(root))


def test_the_small_root_keeps_the_layer_kinds(small_root):
    conf = harness.config(CONF, str(small_root))
    cfg = harness.model_config(conf)
    assert [(p.mixer, p.ffn) for p in cfg.pattern] == \
        [("mla", "dense"), ("mla", "moe"), ("mla", "moe")]
    assert harness.architecture(conf).period(conf) == LAYERS


def test_a_sound_run_of_the_cell_is_correct_under_its_limits(small_root):
    r = _run(small_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert sorted(r["metrics"]) == ["serve_tok_s", "setup_s", "ttft_p95_ms"]
    assert all(m["value"] > 0 for m in r["metrics"].values())


def test_a_traced_run_reads_the_absorbed_decode_and_the_prefill(small_root):
    r = _run(small_root, trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for name in ("mla_decode_ms", "prefill_ms", "decode_step_ms", "prefill_mfu"):
        assert got[name]["value"] > 0, name
    assert got["mla_decode_ms"]["value"] < got["decode_step_ms"]["value"]


def test_a_fault_of_the_timed_path_is_not_correct(small_root):
    with faults.planted("tokens"):
        r = _run(small_root)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("over,word", [({"norm_topk_prob": True}, "norm_topk_prob"),
                                       ({"kv_lora_rank": 16}, "kv_lora_rank")])
def test_check_program_refuses_renormalised_gates_and_another_latent_width(small_root,
                                                                          over, word):
    path = small_root / "portbench/configs" / f"{CONF}.json"
    good = path.read_text()
    conf = json.loads(good)
    try:
        path.write_text(json.dumps(dict(conf, overrides=dict(conf["overrides"], **over))))
        with pytest.raises(ValueError, match=word):
            harness.make_cell(CELL, SEED, 1.0, False, "cpu", str(small_root))
    finally:
        path.write_text(good)


@pytest.mark.cuda
def test_at_the_cells_own_size_the_program_passes_and_the_control_fails(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.undo()                          # the published 27 layers
    c, wl, _ = harness.make_cell(CELL, SEED, 6.0, False, "cuda")
    out = harness.driver(wl["driver"]).run(c)
    out.release()
    program, control = out.check(), out.control()
    assert all(program[k] <= v for k, v in wl["limits"].items()), (program, wl["limits"])
    assert any(control[k] > v for k, v in wl["limits"].items()), (control, wl["limits"])

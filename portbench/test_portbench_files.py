"""The benchmark's files against its contract: every name resolves to a
file, every file is named, names and units use the allowed characters,
nothing imports JAX or the JAX package, and the command refuses to run
without a card or without the program."""

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.ROOT)
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.spec(str(ROOT))


def test_every_name_is_a_file_and_every_file_a_name(spec):
    cells = {w["name"] for w in spec["workloads"]}
    confs = {c["name"] for c in spec["configs"]}
    assert {p.stem for p in (BENCH / "workloads").glob("*.json")} == cells
    assert {p.stem for p in (BENCH / "configs").glob("*.json")} == confs
    assert {p.stem for p in (BENCH / "metrics").glob("*.py")} == \
        {m["name"] for m in spec["per_layer"]}
    drivers = {p.stem for p in (BENCH / "drivers").glob("*.py")}
    for c in spec["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        conf = harness.config(c["name"], str(ROOT))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        wl = harness.workload(w["name"], str(ROOT))
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"] == 1
        assert wl["why"] == w["why"] and len(w["why"]) <= 200
        assert wl["driver"] in drivers
        assert wl["limits"] and all(isinstance(v, (int, float)) and v > 0
                                    for v in wl["limits"].values())
        harness.model_config(harness.config(w["config"], str(ROOT)))
    assert {w["config"] for w in spec["workloads"]} == confs


def test_names_units_and_keys_keep_to_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in spec["workloads"]:
        assert NAME.match(w["traffic"]) and set(w) == {"name", "config", "traffic",
                                                       "chips", "why"}
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in cells:            # every cell reports set-up, one more e2e, one per-layer
        assert sum(c in m.get("workloads", cells) for m in spec["end_to_end"]) >= 2
        assert any(c in m["workloads"] for m in spec["per_layer"])


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert harness.forbidden_modules(["repro_torch.models", "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core.bfile", "jax.numpy", "flax"]) == \
        ["flax", "jax", "repro"]


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package_and_the_reference_no_program():
    for path in BENCH.rglob("*.py"):
        assert not harness.forbidden_modules(_imports(path)), path
    for path in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_harness_imports_with_jax_and_the_jax_package_blocked():
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {harness.FORBIDDEN!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench import harness, flops, kinds, faults, weights
from portbench.reference import model, train
import repro_torch.serve, repro_torch.train, repro_torch.launch.train, repro_torch.data
for d in ("train", "serve_waves"):
    harness.driver(d)
for m in harness.spec()["per_layer"]:
    harness.metric_reader(m["name"])
assert not harness.forbidden_modules(), harness.forbidden_modules()
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def _run(argv, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_command_refuses_without_a_card_and_prints_no_result():
    r = _run(["portbench/run.py", "--workload", "qwen3-8b.prefill-2k",
              "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
             cwd=str(ROOT), env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_command_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(["portbench/run.py", "--workload", "qwen3-8b.prefill-2k",
              "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_seconds_fit_a_full_check_of_24_cells(spec):
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert math.isfinite(spec["run_seconds"])


def test_benchmark_json_is_small_and_plain():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    json.loads(raw)

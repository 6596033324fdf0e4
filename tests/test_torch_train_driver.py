"""The port's training driver on the CPU: the preempt-and-resume drill as
``python -m repro_torch.launch.train``, and resumes across the two
packages in both directions, each from the other's checkpoint and data
cursor.

The cross-package runs use the reduced qwen3-8b in float32 (both drivers'
``reduced`` patched to keep float32 compute), so the resumed run's first
loss can be held to the float32 bound of ``tests/test_torch_train.py``,
1e-5 relative, against the uninterrupted run of the package that wrote
the checkpoint."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as jax_train  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
F32_RTOL = 1e-5
LOG_KEYS = {"loss", "xent", "accuracy", "lb_loss", "z_loss", "tokens",
            "grad_norm", "lr", "step", "tok_per_s"}
RUN = ["--arch", "qwen3-8b", "--reduced", "--steps", "4", "--batch", "4",
       "--seq-len", "32", "--ckpt-every", "2", "--log-every", "1",
       "--n-shards", "2"]


def _log(workdir) -> list[dict]:
    with open(os.path.join(workdir, "train_log.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _cursor(stdout: str) -> dict:
    line = next(l for l in stdout.splitlines() if l.startswith("resumed from"))
    return ast.literal_eval(line[line.index("(cursor ") + 8:-1])


DRILL = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--steps", "6",
         "--batch", "4", "--seq-len", "32", "--ckpt-every", "3",
         "--log-every", "1"]


def _drive(workdir, extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--workdir",
         str(workdir)] + DRILL + extra,
        capture_output=True, text=True, timeout=300, env=env)


def test_preempt_and_resume_as_a_module(tmp_path):
    wd = tmp_path / "run"
    r1 = _drive(wd, ["--simulate-preempt", "3"])
    assert r1.returncode == 17, r1.stderr[-2000:]
    assert "simulated preemption at step 3" in r1.stdout
    r2 = _drive(wd, [])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 3" in r2.stdout
    log = _log(wd)
    assert [m["step"] for m in log] == [1, 2, 3, 4, 5, 6]
    for m in log:
        assert set(m) == LOG_KEYS and all(np.isfinite(v) for v in m.values())
    # the resumed run read on from the cursor: its batches, and so its
    # losses, are the uninterrupted run's (the CPU sums in a fixed order)
    assert _cursor(r2.stdout) == {"epoch": 0, "file_idx": 0,
                                  "window_idx": 12, "seed": 0}
    whole = tmp_path / "whole"
    assert port_train.main(DRILL + ["--workdir", str(whole)]) == 0
    assert [m["loss"] for m in _log(whole)] == [m["loss"] for m in log]


@pytest.fixture
def float32_reduced(monkeypatch):
    """Both drivers' reduced configs, computing in float32."""
    for mod in (jax_train, port_train):
        orig = mod.reduced
        monkeypatch.setattr(
            mod, "reduced",
            lambda cfg, orig=orig: dataclasses.replace(orig(cfg), dtype="float32"))


def _batches_after(workdir, n: int, k: int) -> list[dict]:
    """Batches n .. n+k-1 of the uninterrupted stream over the workdir's
    shards."""
    shards = sorted(str(p) for p in Path(workdir, "data").glob("shard-*.bskt"))
    pipe = TokenPipeline(shards, batch=4, seq_len=32)
    try:
        return [next(pipe) for _ in range(n + k)][n:]
    finally:
        pipe.close()


def _next_batch_at(workdir, cursor: dict) -> dict:
    shards = sorted(str(p) for p in Path(workdir, "data").glob("shard-*.bskt"))
    pipe = TokenPipeline(shards, batch=4, seq_len=32)
    try:
        pipe.load_state_dict(cursor)
        return next(pipe)
    finally:
        pipe.close()


@pytest.mark.parametrize("first", ["reference", "port"])
def test_resume_across_the_packages(tmp_path, capsys, float32_reduced, first):
    """``first`` trains 2 of 4 steps and is preempted; the other package's
    driver resumes from its workdir (checkpoint and cursor).  The resumed
    run's next batch is the uninterrupted stream's third, and its first
    loss is the uninterrupted run's third within the float32 bound."""
    mains = {"reference": jax_train.main,
             "port": lambda argv: port_train.main(["--device", "cpu"] + argv)}
    second = "port" if first == "reference" else "reference"
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert mains[first](RUN + ["--workdir", str(whole)]) == 0
    assert mains[first](RUN + ["--workdir", str(cut),
                               "--simulate-preempt", "2"]) == 17
    capsys.readouterr()
    assert mains[second](RUN + ["--workdir", str(cut)]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    cursor = _cursor(out)
    want = _batches_after(cut, 2, 1)[0]
    got = _next_batch_at(cut, cursor)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    ref_log, log = _log(whole), _log(cut)
    assert [m["step"] for m in log] == [1, 2, 3, 4]
    assert set(log[2]) == set(ref_log[2]) == LOG_KEYS
    for k in ("loss", "xent"):
        np.testing.assert_allclose(log[2][k], ref_log[2][k], rtol=F32_RTOL)
    assert log[2]["lr"] == pytest.approx(ref_log[2]["lr"], rel=1e-6)

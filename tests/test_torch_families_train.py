"""Training the port's MoE, Mamba and encoder-decoder models on the CPU,
against the JAX package.

One train step of each family's ``reduced()`` config (float32) from the
reference's initial state, on the same batch: the losses, the aux
losses the metrics carry, and every parameter after the step against the
jitted reference.  Then ``repro_torch.launch.train --reduced --device
cpu`` for each family (seamless with the driver's stub ``frames``), and
a llama4-scout run preempted in one package and resumed in the other,
in both directions.

Tolerance.  As ``tests/test_torch_train.py``'s float32 bound, 1e-5
(relative; Frobenius for the parameters): the gradients of the two
frameworks sum in other orders, and AdamW's first step moves each weight
by about the learning rate times the sign of its gradient."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.launch.train as jax_train  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.train import init_train_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import tree_from_numpy  # noqa: E402
from repro_torch.checkpoint.manager import _flatten_with_paths  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402

F32_RTOL = 1e-5
ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
         "seamless-m4t-medium"]
HP = dict(peak_lr=1e-3, warmup=1, total_steps=10)
LOG_KEYS = {"loss", "xent", "accuracy", "lb_loss", "z_loss", "tokens",
            "grad_norm", "lr", "step", "tok_per_s"}
RUN = ["--reduced", "--steps", "4", "--batch", "4", "--seq-len", "16",
       "--ckpt-every", "2", "--log-every", "1", "--n-shards", "1"]


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _log(workdir) -> list[dict]:
    with open(os.path.join(workdir, "train_log.jsonl")) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    cfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                              dtype="float32")
    port = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               dtype="float32")
    jm, tm = JaxModel(cfg), Model(port)
    js = jinit_state(jm, jax.random.key(0))
    t = tree_from_numpy(jax.tree.map(np.asarray, {"params": js.params, "opt": js.opt,
                                                  "step": js.step}), device="cpu")
    ts = TrainState(t["params"], t["opt"], t["step"], None)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    raw = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    jb = jax_train.build_batch(cfg, raw, 1)
    tb = port_train.build_batch(port, raw, 1, "cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    js, jmet = jax.jit(jmake_step(jm, **HP))(js, jb)
    ts, tmet = make_train_step(tm, **HP)(ts, tb)
    for k in ("loss", "xent", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=F32_RTOL, err_msg=k)
    assert (float(tmet["lb_loss"]) > 0) == (cfg.n_experts > 0)
    jp = _flatten_with_paths(jax.tree.map(lambda x: np.asarray(x, np.float64), js.params))
    tp = _flatten_with_paths(ts.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        assert _rel(tp[k], jp[k]) < F32_RTOL, (k, _rel(tp[k], jp[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_each_family(arch, tmp_path, capsys):
    wd = tmp_path / "run"
    argv = ["--arch", arch, "--device", "cpu", "--workdir", str(wd)] + RUN
    argv[argv.index("--steps") + 1] = "2"
    assert port_train.main(argv) == 0
    log = _log(wd)
    assert [m["step"] for m in log] == [1, 2]
    for m in log:
        assert set(m) == LOG_KEYS and all(np.isfinite(v) for v in m.values())
        assert (m["lb_loss"] > 0) == ("llama4" in arch or "jamba" in arch)
    assert "final ckpt" in capsys.readouterr().out


@pytest.fixture
def float32_reduced(monkeypatch):
    """Both drivers' reduced configs, computing in float32."""
    for mod in (jax_train, port_train):
        orig = mod.reduced
        monkeypatch.setattr(
            mod, "reduced",
            lambda cfg, orig=orig: dataclasses.replace(orig(cfg), dtype="float32"))


@pytest.mark.parametrize("first", ["reference", "port"])
def test_moe_resume_across_the_packages(tmp_path, capsys, float32_reduced, first):
    """llama4-scout: ``first`` trains 2 of 4 steps and is preempted; the
    other package resumes from its checkpoint and cursor, and its first
    loss and aux losses are the uninterrupted run's third."""
    run = ["--arch", "llama4-scout-17b-a16e"] + RUN
    mains = {"reference": jax_train.main,
             "port": lambda argv: port_train.main(["--device", "cpu"] + argv)}
    second = "port" if first == "reference" else "reference"
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert mains[first](run + ["--workdir", str(whole)]) == 0
    assert mains[first](run + ["--workdir", str(cut), "--simulate-preempt", "2"]) == 17
    capsys.readouterr()
    assert mains[second](run + ["--workdir", str(cut)]) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    ref_log, log = _log(whole), _log(cut)
    assert [m["step"] for m in log] == [1, 2, 3, 4]
    assert set(log[2]) == set(ref_log[2]) == LOG_KEYS
    for k in ("loss", "xent", "lb_loss", "z_loss"):
        np.testing.assert_allclose(log[2][k], ref_log[2][k], rtol=F32_RTOL, err_msg=k)
